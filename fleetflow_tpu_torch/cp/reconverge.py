"""Reconverger: dead-node verdicts -> warm re-solves -> actual redeploys
(the port's copy of ``fleetflow_tpu/cp/reconverge.py``).

Before this module, the self-healing story stopped half-way: the failure
path recorded heartbeats (store), the health checker could flip a server
offline, and `placement.node_events` would even compute a new assignment —
but nothing DELIVERED that assignment to the surviving agents. A killed
node stranded its services until an operator redeployed by hand. The
reconverger closes the loop (crash-only design: recovery IS the normal
code path):

  FailureDetector.sweep() -> LeaseEvents (dead / node-online verdicts)
      -> placement.node_events(coalesced burst)   one warm re-solve/stage
         (on the card's scheduler the burst rides a structured
         ProblemDelta into the device-resident problem —
         solver/resident.py — so a reconvergence re-solve never
         re-uploads the problem tensors;
         `fleet cp heal status` reports the delta/cold staging counts)
      -> redelivery: DeployRequest per surviving node via
         AgentRegistry.send_command, with
           * per-work idempotency keys (agent/agent.py dedupes a replay
             after reconnect, so at-least-once delivery is safe)
           * bounded-retry exponential backoff + jitter on retryable
             failures (core.errors.AgentUnreachable)
           * one trace_id spanning detection -> re-solve -> redeploy
             (flight-recorder correlation, obs/trace.py)
      -> placement.commit_retained on success + a Deployment record
         (the placement record keeps `fleet down`'s node scan truthful)

Infeasible re-solves and exhausted retries PARK the stage: a ParkedWork
record (persisted through the store journal, so a CP restart resumes
convergence instead of forgetting it) retried on the next node-online
verdict. Solver failures during the re-solve degrade to the greedy host
path inside placement.node_events — healing never stalls on the device.
A fault of the device path itself (`placement._device_fault`: the card
missing, a kernel that does not build or launch, a CUDA error, the card's
memory run out) is never degraded around: node_events re-raises it, the
step requeues the verdicts and re-raises, and `run_loop` ends its task
with it, where the reference logs every failed step and tries again.

The loop is step-driven with an injectable monotonic clock: production
runs `spawn()` (asyncio task, `interval_s` cadence); the chaos harness
calls `await step()` from its replay loop on the virtual clock, which is
what makes `rolling-kill-selfheal` a deterministic, digest-reproducible
scenario.

The reconverger reads three attributes of its `state`: `store`,
`placement` and `agent_registry` (`HealState`). Any holder of the three
serves: the server's `AppState` (`cp/server.py`) is one, which `start`
hands it.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import time
import uuid
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Protocol

from ..core.errors import AgentCommandError, AgentUnreachable
from ..obs import get_logger, kv, span
from ..obs.metrics import REGISTRY
from ..obs.slo import observe as slo_observe
from ..obs.trace import new_trace_id, use_trace
from ..runtime.engine import DeployRequest
from .agent_registry import DEPLOY_TIMEOUT
from .failure_detector import FailureDetector, LeaseEvent
from .models import Deployment, DeploymentStatus, ParkedWork
from .placement import _device_fault

if TYPE_CHECKING:
    from .agent_registry import AgentRegistry
    from .placement import PlacementService
    from .store import Store

log = get_logger("cp.reconverge")

__all__ = ["ReconvergeConfig", "Reconverger", "HealState"]

# metric catalog: docs/guide/10-observability.md
_M_RECONVERGE_S = REGISTRY.histogram(
    "fleet_reconverge_duration_seconds",
    "Verdict-handling pass wall time: coalesced churn re-solve + "
    "redelivery fan-out")
_M_REDELIVERIES = REGISTRY.counter(
    "fleet_reconverge_redeliveries_total",
    "Self-heal deploy redeliveries, by outcome", labels=("outcome",))
_M_PARKED = REGISTRY.gauge(
    "fleet_reconverge_parked",
    "Stages parked by the reconverger (infeasible or retries exhausted), "
    "awaiting a node-online verdict")


class HealState(Protocol):
    """What the reconverger reads of the control plane's state."""
    store: "Store"
    placement: "PlacementService"
    agent_registry: "AgentRegistry"


@dataclass
class ReconvergeConfig:
    """Backoff/parking knobs (docs/guide/12-self-healing.md)."""
    interval_s: float = 5.0          # background loop cadence
    backoff_base_s: float = 2.0      # first retry delay
    backoff_max_s: float = 60.0      # delay ceiling
    max_attempts: int = 5            # then the stage parks


@dataclass
class _Work:
    """One stage's convergence debt: redeliver its retained placement, or
    (parked) wait for capacity to return."""
    stage_key: str
    idempotency_key: str
    trace_id: str
    attempt: int = 0
    next_try_at: float = 0.0
    parked: bool = False
    reason: str = ""
    last_error: str = ""
    # when the VERDICT that opened this debt fired (engine clock; None =
    # unstamped — 0.0 is a legitimate reading on a virtual clock):
    # retire-on-success observes clock() - verdict_at into the heal_s
    # SLO stream — the verdict→converged time-to-heal (obs/slo.py).
    # Superseding work (a fresh burst re-solve for a still-open stage)
    # inherits the ORIGINAL stamp: the operator's question is "how long
    # was the stage degraded", not "how long did the last attempt take".
    verdict_at: Optional[float] = None


class Reconverger:
    def __init__(self, state: HealState, detector: FailureDetector, *,
                 config: Optional[ReconvergeConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.state = state
        self.detector = detector
        self.config = config or ReconvergeConfig()
        self.clock = clock
        # jitter source: seeded by the chaos harness so retry timing is
        # replay-deterministic; fresh entropy in production
        self.rng = rng or random.Random()
        self._work: dict[str, _Work] = {}
        self._gen = itertools.count(1)
        # per-process nonce in every idempotency key: the counter restarts
        # with the CP, and a restarted CP's key "g1" must not collide with
        # an entry still live in an agent's dedupe window (the agent would
        # answer a DIFFERENT assignment's redelivery from the cache)
        self._key_nonce = uuid.uuid4().hex[:8]
        self._task: Optional[asyncio.Task] = None
        self.stats = {"verdicts_dead": 0, "verdicts_online": 0,
                      "resolves": 0, "redeliveries_ok": 0,
                      "redeliveries_retried": 0, "parked": 0, "resumed": 0,
                      "rebuilt_solves": 0}

    # ------------------------------------------------------------------
    # persistence (crash-restart resume)
    # ------------------------------------------------------------------

    def resume(self) -> int:
        """Reload convergence debt a previous CP process left in the
        store: parked stages stay parked; in-flight redelivery work
        retries immediately (the restart may BE the reason it never
        finished). Called once at server start — and again on standby
        promotion, where "previous process" is the dead primary and the
        store contents arrived via replication."""
        n = 0
        for rec in self.state.store.list("parked_work"):
            if rec.stage_key in self._work:
                continue
            self._work[rec.stage_key] = _Work(
                stage_key=rec.stage_key,
                idempotency_key=f"heal-{rec.stage_key}-r{rec.id}",
                trace_id=new_trace_id(), attempt=rec.attempt,
                next_try_at=self.clock(), parked=rec.parked,
                reason=rec.reason or "resumed", last_error=rec.detail,
                # the original verdict died with the predecessor; the
                # resumed heal clock starts here (undercounts across a
                # failover rather than inventing a cross-process stamp)
                verdict_at=self.clock())
            n += 1
        if n:
            self.stats["resumed"] += n
            log.info("resumed convergence backlog %s", kv(stages=n))
        self._rehydrate_placements()
        self._set_parked_gauge()
        return n

    def _rehydrate_placements(self) -> None:
        """Rebuild the placement book from replicated records: every
        committed stage gets its running assignment re-adopted as the
        retained placement (PlacementService.rehydrate). Without this a
        freshly promoted/restarted CP cannot re-place those stages when
        their nodes die later — node_events only moves stages it holds
        retained problems for."""
        placement = self.state.placement
        rehydrate = getattr(placement, "rehydrate", None)
        if rehydrate is None:   # minimal placement fake (unit tests)
            return
        n = 0
        for rec in self.state.store.list("placements"):
            if placement.retained(rec.stage_key) is not None:
                continue
            req, tenant = self._template(rec.stage_key)
            if req is None:
                continue
            try:
                if rehydrate(rec.stage_key, req.flow, tenant=tenant):
                    n += 1
            except Exception as e:
                if _device_fault(e):
                    raise
                log.exception("placement rehydration failed %s",
                              kv(stage=rec.stage_key))
        if n:
            self.stats["rehydrated"] = self.stats.get("rehydrated", 0) + n
            log.info("placement book rehydrated %s", kv(stages=n))

    def _persist(self, w: _Work) -> None:
        db = self.state.store
        rec = db.find_one("parked_work",
                          lambda r: r.stage_key == w.stage_key)
        attrs = dict(reason=w.reason, parked=w.parked, attempt=w.attempt,
                     detail=w.last_error[:500])
        if rec is None:
            db.create("parked_work", ParkedWork(stage_key=w.stage_key,
                                                **attrs))
        else:
            db.update("parked_work", rec.id, **attrs)

    def _unpersist(self, stage_key: str) -> None:
        db = self.state.store
        rec = db.find_one("parked_work",
                          lambda r: r.stage_key == stage_key)
        if rec is not None:
            db.delete("parked_work", rec.id)

    def _set_parked_gauge(self) -> None:
        _M_PARKED.set(sum(1 for w in self._work.values() if w.parked))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        """Non-parked redelivery debt outstanding (the chaos settle loop
        keeps advancing the clock until this drains)."""
        return any(not w.parked for w in self._work.values())

    def parked_stage_keys(self) -> list[str]:
        return sorted(k for k, w in self._work.items() if w.parked)

    def pending_stage_keys(self) -> list[str]:
        """Stages with ACTIVE redelivery debt (not parked) — what the
        chaos liveness invariant requires to be empty after settle."""
        return sorted(k for k, w in self._work.items() if not w.parked)

    def debt(self) -> int:
        """Count of stages with active (non-parked) redelivery work —
        the collector's deep gauge (fleet_reconverge_redelivery_debt).
        A plain dict scan; safe from the sampler cadence."""
        return sum(1 for w in self._work.values() if not w.parked)

    def status(self) -> dict:
        """`fleet cp heal status` payload."""
        now = self.clock()
        return {
            "detector": self.detector.status(),
            "config": {"interval_s": self.config.interval_s,
                       "backoff_base_s": self.config.backoff_base_s,
                       "backoff_max_s": self.config.backoff_max_s,
                       "max_attempts": self.config.max_attempts},
            "work": [{"stage": w.stage_key, "parked": w.parked,
                      "attempt": w.attempt, "reason": w.reason,
                      "retry_in_s": (None if w.parked else
                                     round(max(w.next_try_at - now, 0), 3)),
                      "last_error": w.last_error[:200]}
                     for _, w in sorted(self._work.items())],
            "stats": dict(self.stats),
            # how the churn re-solves behind the verdicts were staged:
            # delta = merged into the device-resident problem (the
            # sub-10ms warm path, docs/guide/11-performance.md), cold =
            # full host restaging (content drift / first solve). Host-path
            # CPs report zeros — the card's scheduler owns these counters.
            "resident": self._resident_stats(),
        }

    @staticmethod
    def _resident_stats() -> dict:
        from ..obs.metrics import REGISTRY
        from .admission import subsolve_outcomes
        reuse = REGISTRY.get("fleet_solver_resident_reuse_total")
        xfers = REGISTRY.get("fleet_solver_host_transfers_total")
        return {
            "delta_reuse": int(reuse.value(outcome="delta")) if reuse else 0,
            "cold_stagings": int(reuse.value(outcome="cold")) if reuse else 0,
            "host_transfers": int(xfers.value()) if xfers else 0,
            # active-set dispatch outcomes (solver/subsolve.py): the heal
            # path's churn re-solves are exactly what it localizes
            "subsolve": subsolve_outcomes(),
        }

    # ------------------------------------------------------------------
    # the convergence step
    # ------------------------------------------------------------------

    async def step(self, drive: bool = True) -> dict:
        """One pass: sweep the detector, turn verdicts into a coalesced
        churn burst, enqueue/park per-stage work, then drive every due
        redelivery. Returns a deterministic summary (the chaos runner
        logs it into the replayable event log).

        `drive=False` stops after the verdict/bookkeeping half — the
        chaos harness uses it to kill a primary BETWEEN enqueuing
        redelivery work and delivering it (the mid-redelivery crash
        window the cp-failover scenario must cover)."""
        summary = {"dead": [], "online": [], "resolved": [],
                   "redelivered": [], "retried": [], "parked": []}
        events = self.detector.sweep()
        if events:
            try:
                await self._handle_verdicts(events, summary)
            except Exception as e:
                # verdicts were requeued by _handle_verdicts; the step
                # itself survives (the loop's next pass retries them),
                # unless the device path itself failed: that ends it
                if _device_fault(e):
                    raise
                log.exception("verdict handling failed; will retry")
                summary["dead"], summary["online"] = [], []
                summary["resolved"] = []
        if drive:
            await self._drive_due(summary)
        return summary

    async def _handle_verdicts(self, events: list[LeaseEvent],
                               summary: dict) -> None:
        dead = [e.slug for e in events if not e.online]
        online = [e.slug for e in events if e.online]
        self.stats["verdicts_dead"] += len(dead)
        self.stats["verdicts_online"] += len(online)
        summary["dead"] = dead
        summary["online"] = online
        trace_id = new_trace_id()
        t0 = time.perf_counter()
        with use_trace(trace_id):
            with span(log, "reconverge", dead=",".join(dead) or None,
                      online=",".join(online) or None) as sp:
                burst = [(e.slug, e.online) for e in events]
                try:
                    # the warm re-solve runs off-loop: heartbeats and
                    # command_result traffic must keep flowing while the
                    # card works
                    moved = await asyncio.get_running_loop(
                        ).run_in_executor(
                            None,
                            lambda: self.state.placement.node_events(burst))
                except Exception:
                    # the verdicts are NOT consumed: requeue so the next
                    # step retries them (placement.node_events already
                    # degrades to the host path internally; reaching here
                    # means something worse — but never lose a verdict)
                    self.detector.requeue(events)
                    raise
                self.stats["resolves"] += len(moved)
                sp["stages"] = len(moved) or None
                for key, placement in moved:
                    summary["resolved"].append(
                        {"stage": key, "feasible": placement.feasible})
                    # per-stage isolation: a store/persist hiccup on one
                    # stage must not abort the loop — the verdicts were
                    # already consumed by sweep(), so any stage skipped
                    # here would lose its redelivery work forever
                    try:
                        if placement.feasible:
                            self._enqueue(key, trace_id)
                        else:
                            self._park(
                                self._work.get(key)
                                or _Work(stage_key=key,
                                         idempotency_key=self._next_key(key),
                                         trace_id=trace_id,
                                         verdict_at=self.clock()),
                                "infeasible",
                                f"violations={placement.violations}")
                            summary["parked"].append(key)
                    except Exception:
                        log.exception("work bookkeeping failed %s",
                                      kv(stage=key))
                if online:
                    # returned capacity: wake every parked stage the burst
                    # re-solve didn't already reach — its full redeploy
                    # solves fresh against the grown inventory
                    touched = {key for key, _ in moved}
                    for key in self.parked_stage_keys():
                        if key not in touched:
                            try:
                                self._unpark(key, trace_id)
                            except Exception:
                                log.exception("unpark failed %s",
                                              kv(stage=key))
        _M_RECONVERGE_S.observe(time.perf_counter() - t0)

    def _next_key(self, stage_key: str) -> str:
        return f"heal-{stage_key}-{self._key_nonce}-g{next(self._gen)}"

    def _enqueue(self, stage_key: str, trace_id: str) -> None:
        """New feasible assignment for a stage: (re)start its redelivery
        work. A fresh assignment supersedes older debt — and gets a fresh
        idempotency key, because the PAYLOAD changed (dedupe must only
        ever suppress replays of the same assignment)."""
        prev = self._work.get(stage_key)
        w = _Work(stage_key=stage_key,
                  idempotency_key=self._next_key(stage_key),
                  trace_id=trace_id, next_try_at=self.clock(),
                  reason="redeliver",
                  # time-to-heal runs from the FIRST verdict that opened
                  # this stage's still-unhealed debt
                  verdict_at=(prev.verdict_at
                              if prev is not None
                              and prev.verdict_at is not None
                              else self.clock()))
        self._work[stage_key] = w
        self._persist(w)
        self._set_parked_gauge()

    def _unpark(self, stage_key: str, trace_id: str) -> None:
        w = self._work.get(stage_key)
        if w is None or not w.parked:
            return
        w.parked = False
        w.attempt = 0
        w.trace_id = trace_id
        w.reason = "unparked"
        # the payload the redelivery will carry is whatever the fresh
        # re-solve produced, not what was parked: a stale (or empty —
        # the infeasible-park placeholder's) key must never ride along,
        # or a timeout retry would lose its dedupe protection
        w.idempotency_key = self._next_key(stage_key)
        w.next_try_at = self.clock()
        self._persist(w)
        self._set_parked_gauge()
        log.info("unparked %s", kv(stage=stage_key))

    def _park(self, w: _Work, reason: str, detail: str = "") -> None:
        w.parked = True
        w.reason = reason
        w.last_error = detail
        self._work[w.stage_key] = w
        self.stats["parked"] += 1
        _M_REDELIVERIES.inc(outcome="parked")
        self._persist(w)
        self._set_parked_gauge()
        log.warning("parked %s", kv(stage=w.stage_key, reason=reason,
                                    detail=detail or None))

    def _retry(self, w: _Work, summary: dict, error: str) -> None:
        w.attempt += 1
        w.last_error = error
        if w.attempt >= self.config.max_attempts:
            self._park(w, "retries-exhausted", error)
            summary["parked"].append(w.stage_key)
            return
        base = min(self.config.backoff_max_s,
                   self.config.backoff_base_s * (2 ** (w.attempt - 1)))
        # full-jitter-lite: 75-125% of the exponential step, so a burst of
        # displaced stages doesn't hammer the surviving agents in lockstep
        w.next_try_at = self.clock() + base * (0.75 + 0.5 * self.rng.random())
        self.stats["redeliveries_retried"] += 1
        _M_REDELIVERIES.inc(outcome="retry")
        self._persist(w)
        summary["retried"].append(w.stage_key)
        log.info("redelivery retry scheduled %s", kv(
            stage=w.stage_key, attempt=w.attempt,
            delay_s=round(w.next_try_at - self.clock(), 2), error=error))

    async def _drive_due(self, summary: dict) -> None:
        now = self.clock()
        due = [w for _, w in sorted(self._work.items())
               if not w.parked and w.next_try_at <= now]
        for w in due:
            with use_trace(w.trace_id):
                try:
                    ok = await self._redeliver(w)
                except AgentCommandError as e:
                    if e.retryable:
                        self._retry(w, summary, str(e))
                    else:
                        # the agent ran the deploy and failed it: retrying
                        # verbatim reruns the failure — park for operator
                        # attention / the next topology change
                        self._park(w, "deploy-failed", str(e))
                        summary["parked"].append(w.stage_key)
                    continue
                except Exception as e:  # solver/store surprises: retry
                    if _device_fault(e):
                        raise
                    self._retry(w, summary, f"{type(e).__name__}: {e}")
                    continue
            if ok:
                summary["redelivered"].append(w.stage_key)

    # ------------------------------------------------------------------
    # redelivery
    # ------------------------------------------------------------------

    def _template(self, stage_key: str
                  ) -> tuple[Optional[DeployRequest], str]:
        """The stage's replay template: the newest deployment record that
        stored its request (execute_deploy does; so do our own heal
        records). Returns (request, tenant)."""
        project_name, _, stage_name = stage_key.partition("/")
        for d in reversed(self.state.store.list("deployments")):
            req = d.request
            if (req and req.get("stage_name") == stage_name
                    and (req.get("flow") or {}).get("name") == project_name):
                return DeployRequest.from_dict(dict(req)), d.tenant
        return None, "default"

    async def _redeliver(self, w: _Work) -> bool:
        """Push the stage's retained assignment to its surviving nodes.
        True on full success (work retired); raises AgentCommandError on
        per-node failure (classified by the caller)."""
        key = w.stage_key
        entry = self.state.placement.retained(key)
        if entry is None:
            # No retained placement for in-flight work means THIS process
            # never solved the stage: the work was inherited from a dead
            # predecessor (CP restart, or a standby promoted mid-
            # redelivery). Rebuild the retry state from replicated
            # records: a fresh solve from the stored deployment template
            # repopulates the retained entry, and the redelivery proceeds
            # as if the solve had happened here. Only when there is no
            # template either is the stage truly gone.
            entry = await self._rebuild_retained(w)
            if entry is None:
                return False
        _pt, placement = entry
        if not placement.feasible:
            self._park(w, "infeasible",
                       f"violations={placement.violations}")
            return False
        req, tenant = self._template(key)
        if req is None:
            self._park(w, "no-template",
                       "no stored deployment request to replay")
            return False
        assignment = dict(placement.assignment)
        targets = sorted({node for node in assignment.values()})
        registry = self.state.agent_registry
        absent = [t for t in targets if not registry.is_connected(t)]
        if absent:
            raise AgentUnreachable(
                f"assigned nodes not connected: {absent}",
                reason="not-connected")
        with span(log, "heal.redeliver", stage=key,
                  nodes=",".join(targets), attempt=w.attempt) as sp:
            # one BATCH to the registry (not one awaited future per
            # node): each target rides its owning shard's bounded
            # pipeline lane — cp/shards.py — and the per-command metric
            # labels + fencing epoch are resolved once for the batch
            results = await registry.send_batch(
                [(slug, "deploy.execute",
                  {"request": DeployRequest(
                      flow=req.flow, stage_name=req.stage_name,
                      no_pull=req.no_pull, no_prune=req.no_prune,
                      node=slug, trace_id=w.trace_id).to_dict(),
                   "assignment": assignment,
                   "idempotency_key": w.idempotency_key})
                 for slug in targets], timeout=DEPLOY_TIMEOUT)
            failures = [r for r in results if isinstance(r, Exception)]
            if failures:
                # prefer the retryable classification: if ANY node failed
                # retryably the whole redelivery is worth retrying (the
                # idempotency key makes re-sending to the ok nodes safe)
                retryable = [f for f in failures
                             if getattr(f, "retryable", False)]
                raise (retryable[0] if retryable else failures[0])
            self.state.placement.commit_retained(key)
            self._record_deployment(key, tenant, req, assignment, targets)
            sp["nodes_ok"] = len(targets)
        self.stats["redeliveries_ok"] += 1
        _M_REDELIVERIES.inc(outcome="ok")
        if w.verdict_at is not None:
            # verdict → converged, on the engine clock (virtual in
            # chaos): the heal-p99-s SLO stream (obs/slo.py)
            slo_observe("heal_s", max(self.clock() - w.verdict_at, 0.0))
        self._retire(w)
        log.info("stage reconverged %s", kv(stage=key,
                                            nodes=",".join(targets)))
        return True

    async def _rebuild_retained(self, w: _Work):
        """Failover/restart path: re-solve the stage from its stored
        deployment template so redelivery has a placement to carry.
        Returns the retained (pt, placement) entry, or None after
        retiring/parking the work."""
        key = w.stage_key
        req, tenant = self._template(key)
        if req is None:
            # stage torn down / never solved anywhere: nothing to converge
            self._retire(w)
            return None
        solve = getattr(self.state.placement, "solve_stage", None)
        if solve is None:   # minimal placement fake (unit tests)
            self._retire(w)
            return None
        with span(log, "heal.rebuild", stage=key, attempt=w.attempt):
            # reserve=False: commit_retained books the capacity when the
            # redelivery lands, same as the node_events churn path
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: solve(req.flow, req.stage_name,
                                    tenant=tenant, reserve=False))
        self.stats["rebuilt_solves"] += 1
        log.info("retained placement rebuilt from template %s",
                 kv(stage=key))
        return self.state.placement.retained(key)

    def _retire(self, w: _Work) -> None:
        self._work.pop(w.stage_key, None)
        self._unpersist(w.stage_key)
        self._set_parked_gauge()

    def _record_deployment(self, stage_key: str, tenant_name: str,
                           req: DeployRequest, assignment: dict,
                           targets: list[str]) -> None:
        """The heal lands in deployment history like any deploy — and
        records its placement, which `fleet down`'s node scan treats as
        the truth about WHERE containers live (handlers.execute_down)."""
        db = self.state.store
        tenant = db.ensure_tenant(tenant_name)
        project = db.ensure_project(tenant.name, req.flow.name)
        stage_cfg = req.flow.stage(req.stage_name)
        stage = db.ensure_stage(project.id, req.stage_name)
        stored_req = req.to_dict()
        stored_req.pop("trace_id", None)
        stored_req.pop("node", None)
        dep = db.create("deployments", Deployment(
            tenant=tenant.name, project=project.id, stage=stage.id,
            status=DeploymentStatus.RUNNING.value,
            services=[s.name for s in stage_cfg.resolved_services(req.flow)],
            placement=assignment, request=stored_req))
        db.finish_deployment(dep.id, DeploymentStatus.SUCCEEDED,
                             log=f"self-heal redeploy to "
                                 f"{', '.join(targets)}")
        for svc in dep.services or []:
            db.upsert_service(stage.id, svc, status="deployed")

    # ------------------------------------------------------------------
    # background loop (production)
    # ------------------------------------------------------------------

    async def run_loop(self) -> None:
        while True:
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a fault of the device path itself ends the task with it:
                # retrying around a missing card or a broken kernel would
                # stall healing behind log lines
                if _device_fault(e):
                    raise
                log.exception("reconverge step failed")
            await asyncio.sleep(self.config.interval_s)

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run_loop())
        return self._task

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
