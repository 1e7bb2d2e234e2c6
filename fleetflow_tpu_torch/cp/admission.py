"""Streaming admission: continuous service arrivals/departures as bucketed
micro-solves with backpressure, tenant fairness, and autoscaler feedback
(the port's copy of ``fleetflow_tpu/cp/admission.py``; on the card every
micro-solve is a resident delta merge and, when churn is local, a K5
sub-solve).

Placement used to be burst-driven (deploy commands, coalesced reconvergence
bursts). Serving millions of users means a *continuous* stream of service
arrivals and departures, and the resident solver is exactly the substrate
that makes a streaming steady state cheap: device-resident problems whose
churn arrives as in-place `ProblemDelta` merges, padded onto
`solver/buckets.py` shape tiers so in-tier drift reuses ONE staging. This
module is the serving-stack front half — the continuous
batcher in front of that warm solve path:

  submit()    bounded, per-tenant FIFO sub-queues. Depth and age
              watermarks implement BACKPRESSURE: past the depth bound the
              policy either SHEDS (a structured, retryable
              `AdmissionRejected` the client backs off on) or PARKS
              (accepted, deferred until the queue drains); requests that
              out-age the age watermark are shed by the drain loop so the
              queue can never grow a stale tail.
  step()      one drain pass: a DEFICIT-ROUND-ROBIN scan over the tenant
              sub-queues builds one bucketed micro-batch (weighted max-min
              fairness — an arrival storm from one tenant cannot starve
              the others), the batch folds into the stage's streaming
              problem (tombstoned departures, row-reusing arrivals), and
              ONE micro-solve rides the resident delta path through
              `PlacementService.admit_batch`, committed as ONE reservation.
  pressure()  the autoscaler feedback signal (cp/autoscaler.py): sustained
              queue age or infeasible-parked arrivals mean the SOLVER is
              the bottleneck or the fleet is full — provision nodes; a
              drained queue releases the hold so idle scale-down resumes.

The streaming problem shape (why steady state is zero-restage,
zero-host-transfer):

  * a DEPARTURE tombstones its row in place — demand zeroed by a
    `ProblemDelta` row scatter; the row index goes on a free list. The
    (S, N) planes never reshape, so the padded tier (and its staging)
    survives.
  * an ARRIVAL first reuses a free tombstone row (same-shape scatter), and
    only appends a fresh row — activating an on-device phantom row via the
    delta's `n_real` bump — when the free list is empty. At steady state
    (arrivals ~ departures) rows recirculate and S is constant.
  * streamed services must be SIMPLE: resources + optional node
    eligibility, one replica, no ports/volumes/anti-affinity/colocation/
    dependencies — exactly the churn the delta path can express
    (solver/resident.py `_arrivals_compatible`). Richer services go through
    the full deploy path (`deploy.execute`), which re-lowers and
    cold-stages honestly.
  * when the row count would cross its shape tier and tombstones exist,
    the stream COMPACTS (drops tombstone rows and cold-restages once) —
    amortized, counted, and absent at steady state.

Determinism contract (pinned by tests/test_torch_admission.py): events
fold into the streaming problem in submission order within each tenant.
On the host greedy path a micro-solve is a pure function of the resulting
problem content — so replaying a stream through any batch chunking
commits the same final placement as one equivalent batch solve. On the
card a warm micro-solve starts from the resident assignment, where the
rows arrivals activate keep the batched seed's phantom placement, so the
chunking shows in the placement, as on the reference's accelerator.

Metric catalog: docs/guide/10-observability.md. Knobs + runbook:
docs/guide/14-streaming-admission.md.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Callable, Optional

import numpy as np

from ..core.errors import ControlPlaneError
from ..core.model import Flow, ResourceSpec, Service
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from ..obs.slo import observe as slo_observe
from ..solver.buckets import bucket_config, bucket_size
from ..solver.resident import ProblemDelta
from .placement import _device_fault

# the active-set dispatch vocabulary (solver/subsolve.py), read via the
# registry
SUBSOLVE_OUTCOMES = ("localized", "fallback_closure", "fallback_small",
                     "fallback_infeasible")


def subsolve_outcomes() -> dict:
    m = REGISTRY.get("fleet_solver_subsolve_total")
    return {o: (int(m.value(outcome=o)) if m is not None else 0)
            for o in SUBSOLVE_OUTCOMES}

log = get_logger("cp.admission")

__all__ = ["AdmissionConfig", "AdmissionController", "AdmissionRejected",
           "AdmissionRequest"]

_M_DEPTH = REGISTRY.gauge(
    "fleet_admission_queue_depth",
    "Service arrivals/departures queued for admission across all tenants")
_M_OLDEST = REGISTRY.gauge(
    "fleet_admission_oldest_age_seconds",
    "Age of the oldest queued admission request")
_M_BATCH = REGISTRY.histogram(
    "fleet_admission_batch_size",
    "Events folded into one admission micro-solve",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
_M_BATCH_AGE = REGISTRY.histogram(
    "fleet_admission_batch_age_seconds",
    "Age of the oldest event in a micro-batch at solve time")
_M_WAIT = REGISTRY.histogram(
    "fleet_admission_wait_seconds",
    "Per-request admission latency: submit to committed placement")
_M_ADMITTED = REGISTRY.counter(
    "fleet_admission_admitted_total",
    "Service arrivals committed into a placement, by tenant",
    labels=("tenant",))
_M_DEPARTED = REGISTRY.counter(
    "fleet_admission_departed_total",
    "Service departures committed out of a placement, by tenant",
    labels=("tenant",))
_M_SHEDS = REGISTRY.counter(
    "fleet_admission_sheds_total",
    "Admission requests shed by backpressure, by reason "
    "(depth = queue bound hit at submit, age = out-aged the watermark)",
    labels=("reason",))
_M_PARKED = REGISTRY.counter(
    "fleet_admission_parked_total",
    "Arrivals parked (accepted but deferred: infeasible micro-solve or "
    "park-on-full policy)")
_M_UNPARKED = REGISTRY.counter(
    "fleet_admission_unparked_total",
    "Parked arrivals re-queued after capacity freed up")
_M_QUOTA_PARKED = REGISTRY.counter(
    "fleet_admission_quota_parked_total",
    "Arrivals parked by a per-tenant hard quota cap, by tenant (accepted "
    "but deferred until the tenant's live+queued count drops under its cap)",
    labels=("tenant",))
_M_SOLVES = REGISTRY.counter(
    "fleet_admission_solves_total",
    "Admission micro-solves, by outcome",
    labels=("outcome",))
_M_RATE = REGISTRY.gauge(
    "fleet_admission_placements_per_s",
    "Sustained admission throughput over the most recent drain window "
    "(committed arrivals per wall-clock second of micro-solving)")
_M_DEBT = REGISTRY.gauge(
    "fleet_admission_fairness_debt",
    "Deficit-round-robin credit per tenant (requests the tenant may pop "
    "before yielding the drain to the next tenant)",
    labels=("tenant",))
_M_PHASE = REGISTRY.histogram(
    "fleet_admission_solve_phase_ms",
    "Wall milliseconds per admission drain phase: drain = parked "
    "retry + age shed + DRR batch pop, fold = candidate delta-problem "
    "build (+compaction), solve = resident micro-solve(s), commit = "
    "reservation commit + row bookkeeping — the p99-vs-p50 breakdown "
    "the solve-tail hunt needs",
    labels=("phase",),
    buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500))


class AdmissionRejected(ControlPlaneError):
    """Backpressure: the admission queue refused this submit. RETRYABLE —
    the client should back off `retry_after_s` and resubmit; `reason` is a
    short stable token (queue-depth | age) for metrics and log labels."""

    retryable = True

    def __init__(self, message: str, *, reason: str = "queue-depth",
                 retry_after_s: float = 1.0):
        super().__init__(f"admission rejected ({reason}, "
                         f"retry_after_s={retry_after_s:g}): {message}")
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass
class AdmissionConfig:
    max_queue: int = 4096        # depth watermark: bound on queued requests
    shed_age_s: float = 120.0    # age watermark: queued longer is shed
    on_full: str = "shed"        # shed | park (policy at the depth bound)
    batch_max: int = 128         # events per micro-solve (delta scatter tier)
    quantum: float = 8.0         # DRR credit per unit weight per visit
    tenant_weights: dict[str, float] = field(default_factory=dict)
    # per-tenant HARD caps on streamed arrivals: live + queued + parked
    # may never exceed the cap. Overflow arrivals PARK with reason
    # "quota" (accepted, deferred — not shed: the client did nothing
    # wrong, the tenant is at its purchased ceiling) and re-queue only
    # when departures open headroom. Absent tenant = uncapped.
    tenant_caps: dict[str, int] = field(default_factory=dict)
    # autoscaler feedback: queue age that counts as solver pressure, and
    # how long it must persist before the autoscaler provisions on it
    pressure_age_s: float = 5.0
    pressure_sustain_s: float = 15.0
    # parked arrivals retry when capacity frees (a departure commits or a
    # stream re-syncs); 0 disables parking retry entirely
    drain_interval_s: float = 0.5


@dataclass
class AdmissionRequest:
    """One queued arrival or departure. `state` is the census the chaos
    `admission-converged` invariant audits: every request must end
    terminal (placed | departed | parked | shed | cancelled), never lost."""
    id: str
    tenant: str
    kind: str                    # arrival | departure
    name: str
    stage_key: str
    submitted_at: float
    seq: int
    service: Optional[Service] = None
    demand: Optional[np.ndarray] = None        # (R,) arrival demand
    eligible_nodes: Optional[list[str]] = None
    state: str = "queued"
    done_at: Optional[float] = None
    # why a parked request is parked: capacity (infeasible micro-solve),
    # depth (on_full="park" policy), quota (tenant hard cap). Drives the
    # retry policy: quota parks wait for tenant headroom, not capacity
    park_reason: Optional[str] = None

    TERMINAL = frozenset({"placed", "departed", "parked", "shed",
                          "cancelled"})


@dataclass
class _Stream:
    """Per-stage streaming problem state: the canonical row book the
    micro-solves fold into."""
    key: str
    flow: Flow
    stage_name: str
    tenant: str
    pt: object                              # lower.tensors.ProblemTensors
    row_of: dict[str, int] = field(default_factory=dict)   # live name -> row
    tombstones: set[str] = field(default_factory=set)      # masked names
    free_rows: list[int] = field(default_factory=list)     # reusable rows
    streamed: dict[str, int] = field(default_factory=dict)  # name -> seq
    owner: dict[str, str] = field(default_factory=dict)     # name -> tenant


def _simple_reject(svc: Service) -> Optional[str]:
    """Why `svc` cannot ride the streaming delta path (None = it can).
    Mirrors solver/resident._arrivals_compatible: appended rows must bring
    no hard-constraint ids, no dependencies, one replica."""
    if svc.ports:
        return "ports"
    if svc.volumes:
        return "volumes"
    if svc.anti_affinity:
        return "anti_affinity"
    if svc.colocate_with:
        return "colocate_with"
    if svc.depends_on:
        return "depends_on"
    if svc.replicas != 1:
        return f"replicas={svc.replicas}"
    return None


class AdmissionController:
    """The continuous batcher in front of the warm solve path (module
    docstring). Thread-safe; the clock is injectable (time.monotonic in
    production, the chaos VirtualClock in replay) so every watermark and
    wait is exact arithmetic on whichever clock drives the world."""

    def __init__(self, placement, *, clock: Callable[[], float] = time.monotonic,
                 config: Optional[AdmissionConfig] = None, store=None):
        self.placement = placement
        self.clock = clock
        self.cfg = config or AdmissionConfig()
        # journal parked arrivals into this cp/store.py Store (table
        # "admission_parked") so accepted-but-deferred work replicates to
        # standbys and survives a CP failover; None = in-memory only
        self._store = store
        self._lock = threading.Lock()
        self._queues: dict[str, deque[AdmissionRequest]] = {}
        self._deficit: dict[str, float] = {}
        self._rr: list[str] = []          # persistent tenant rotation
        self._rr_idx = 0
        self._parked: list[AdmissionRequest] = []
        self._park_epoch = 0              # capacity epoch parked waits on
        self._capacity_epoch = 0          # bumps when capacity frees up
        self._streams: dict[str, _Stream] = {}
        self._ids = itertools.count(1)
        self._seq = itertools.count(1)
        self.requests: dict[str, AdmissionRequest] = {}
        # per-tenant completed admission waits (the admission-fair
        # invariant's evidence); bounded so a long-lived CP cannot grow it
        self.wait_samples: dict[str, deque[float]] = {}
        self._pressure_since: Optional[float] = None
        # last computed pressure view, readable WITHOUT the controller
        # lock: a drain pass holds the lock for the whole micro-solve,
        # and the autoscaler's feedback must not block on solver wall
        # time (stale by at most one drain tick)
        self._pressure_snapshot: dict = {"queue_depth": 0,
                                         "oldest_age_s": 0.0, "parked": 0,
                                         "parked_quota": 0,
                                         "sustained": False,
                                         "drained": True}
        self.stats = {"admitted": 0, "departed": 0, "sheds": 0,
                      "parked": 0, "unparked": 0, "solves": 0,
                      "compactions": 0, "batches": 0, "quota_parked": 0,
                      "restored": 0}
        # wall-ms of the most recent drain pass, by phase (drain / fold /
        # solve / commit) — surfaced through deploy.admit_status so a
        # p99 solve tail can be attributed to a phase without a profiler
        self.last_phase_ms: dict[str, float] = {}
        # per-micro-solve wall-ms samples (bounded): the solve TAIL is a
        # first-class operator number — `fleet admit status` reports the
        # p50/p99 and the bench's BENCH_ADMIT_ASSERT bounds their ratio
        # so a re-grown tail fails CI instead of hiding in an average
        self.solve_ms_samples: deque[float] = deque(maxlen=4096)
        self._task = None
        self._restore_parked()

    # ------------------------------------------------------------------
    # parked-arrival journal (store table "admission_parked")
    # ------------------------------------------------------------------

    def _journal_park(self, r: AdmissionRequest, reason: str) -> None:
        """Persist a park transition. create() overwrites by id, so a
        re-park of a retried arrival just refreshes its record."""
        r.park_reason = reason
        if self._store is None or r.service is None:
            return
        from .models import ParkedArrival
        svc = r.service
        spec = {"name": svc.name, "image": svc.image,
                "version": svc.version, "cpu": svc.resources.cpu,
                "memory": svc.resources.memory, "disk": svc.resources.disk,
                "labels": dict(svc.labels or {})}
        self._store.create("admission_parked", ParkedArrival(
            id=r.id, tenant=r.tenant, name=r.name, stage_key=r.stage_key,
            submitted_at=r.submitted_at, seq=r.seq, reason=reason,
            spec=spec, eligible_nodes=list(r.eligible_nodes or [])))

    def _unjournal_park(self, r: AdmissionRequest) -> None:
        """A parked arrival re-queued or went terminal: drop its record
        (idempotent — restores and in-memory controllers both land here)."""
        if self._store is not None:
            self._store.delete("admission_parked", r.id)

    def _restore_parked(self) -> None:
        """Rebuild the parked set from the journal (CP failover/restart):
        the promoted primary re-parks what the dead one accepted. Restored
        requests keep their original seq so retry order is preserved, and
        the id/seq counters advance past them so new submits cannot
        collide. They retry as soon as capacity first moves — exactly the
        contract they parked under."""
        if self._store is None:
            return
        rows = self._store.list("admission_parked")
        if not rows:
            return
        max_seq = max_id = 0
        for rec in sorted(rows, key=lambda rec: rec.seq):
            svc = self.make_arrival(dict(rec.spec))
            r = AdmissionRequest(
                id=rec.id, tenant=rec.tenant, kind="arrival", name=rec.name,
                stage_key=rec.stage_key, submitted_at=rec.submitted_at,
                seq=rec.seq, service=svc,
                demand=np.array(svc.resources.as_tuple(), dtype=np.float64),
                eligible_nodes=list(rec.eligible_nodes) or None,
                state="parked", park_reason=rec.reason or "capacity")
            self._parked.append(r)
            self.requests[r.id] = r
            max_seq = max(max_seq, int(rec.seq))
            try:
                max_id = max(max_id, int(str(rec.id).rsplit("_", 1)[1]))
            except (IndexError, ValueError):
                pass
        self._ids = itertools.count(max_id + 1)
        self._seq = itertools.count(max_seq + 1)
        self.stats["restored"] += len(rows)
        log.info("admission parked restored %s",
                 kv(restored=len(rows), max_seq=max_seq))

    # ------------------------------------------------------------------
    # per-tenant hard quota caps
    # ------------------------------------------------------------------

    def _tenant_inflight(self, tenant: str) -> int:
        """Streamed services a cap must count: live + queued arrivals +
        parked arrivals. Departures never count — they only free."""
        live = sum(1 for s in self._streams.values()
                   for t in s.owner.values() if t == tenant)
        queued = sum(1 for r in (self._queues.get(tenant) or ())
                     if r.kind == "arrival")
        parked = sum(1 for r in self._parked
                     if r.tenant == tenant and r.kind == "arrival")
        return live + queued + parked

    def _quota_headroom(self, tenant: str) -> Optional[int]:
        """Remaining arrivals the tenant's hard cap admits right now
        (None = uncapped; may be negative when departures lag)."""
        cap = self.cfg.tenant_caps.get(tenant)
        if cap is None:
            return None
        return int(cap) - self._tenant_inflight(tenant)

    # ------------------------------------------------------------------
    # stage attachment
    # ------------------------------------------------------------------

    def attach(self, flow: Flow, stage_name: str, *,
               tenant: str = "default") -> str:
        """Register a stage as streaming-managed. The stage must have (or
        gets) a committed baseline placement: micro-solves are deltas
        against it. Returns the stage key."""
        key = f"{flow.name}/{stage_name}"
        with self._lock:
            if key in self._streams:
                return key
        entry = self.placement.retained(key)
        if entry is None:
            placement, rid = self.placement.solve_stage(
                flow, stage_name, tenant=tenant)
            if not placement.feasible:
                raise ControlPlaneError(
                    f"cannot attach {key}: baseline placement infeasible "
                    f"({placement.violations} violations)")
            if rid:
                self.placement.commit(rid)
            entry = self.placement.retained(key)
        pt, _ = entry
        with self._lock:
            self._streams[key] = _Stream(
                key=key, flow=flow, stage_name=stage_name, tenant=tenant,
                pt=pt, row_of={n: i for i, n in enumerate(pt.service_names)})
        log.info("admission stream attached %s", kv(stage=key, rows=pt.S))
        return key

    def _stream_for(self, stage: Optional[str]) -> _Stream:
        if stage is not None:
            s = self._streams.get(stage)
            if s is None:
                raise ValueError(
                    f"stage {stage!r} is not admission-managed; attached: "
                    f"{sorted(self._streams)}")
            return s
        if len(self._streams) == 1:
            return next(iter(self._streams.values()))
        raise ValueError(
            f"stage required ({len(self._streams)} streams attached: "
            f"{sorted(self._streams)})")

    def _resync(self, stream: _Stream) -> None:
        """Another solve path replaced the stage's retained problem:
        adopt it as the new streaming baseline. A flow re-lower (redeploy,
        full re-solve) carries no tombstone rows — the controller keeps
        the flow compacted — so the book resets; but a CHURN re-solve
        (placement.node_events) reuses the streaming pt's rows, so any
        tombstone names still present must CARRY OVER: wiping them would
        unmask departed services in the next committed view and leak
        their rows forever."""
        entry = self.placement.retained(stream.key)
        if entry is None or entry[0] is stream.pt:
            return
        pt = entry[0]
        idx = {n: i for i, n in enumerate(pt.service_names)}
        carried = {n: idx[n] for n in stream.tombstones if n in idx}
        stream.pt = pt
        stream.row_of = {n: i for n, i in idx.items() if n not in carried}
        stream.tombstones = set(carried)
        stream.free_rows = sorted(carried.values())
        self._capacity_epoch += 1       # the world changed under us:
        log.debug("admission stream resynced %s",    # parked get a retry
                  kv(stage=stream.key, rows=pt.S,
                     carried_tombstones=len(carried)))

    # ------------------------------------------------------------------
    # submit (backpressure front door)
    # ------------------------------------------------------------------

    def make_arrival(self, spec: dict) -> Service:
        """Build a streamed Service from a wire spec: {name, image?,
        version?, cpu?, memory?, disk?, eligible_nodes?, labels?}."""
        return Service(
            name=str(spec["name"]),
            image=spec.get("image") or "app",
            version=spec.get("version") or "latest",
            resources=ResourceSpec(cpu=float(spec.get("cpu", 0.1)),
                                   memory=float(spec.get("memory", 64.0)),
                                   disk=float(spec.get("disk", 0.0))),
            labels=dict(spec.get("labels") or {}),
        )

    def submit(self, tenant: str, arrivals=(), departures=(), *,
               stage: Optional[str] = None) -> dict:
        """Enqueue a batch of arrivals (Service or wire spec dicts) and
        departures (service names). Atomic: validates everything first,
        then enqueues everything — a bad entry rejects the whole submit
        with ValueError; backpressure rejects it with AdmissionRejected
        (retryable). Returns {accepted, queued, stage}."""
        now = self.clock()
        with self._lock:
            stream = self._stream_for(stage)
            self._resync(stream)
            svcs: list[Service] = []
            queued_names = {r.name for q in self._queues.values() for r in q
                            if r.kind == "arrival"
                            and r.stage_key == stream.key}
            for a in arrivals:
                svc = a if isinstance(a, Service) else self.make_arrival(a)
                why = _simple_reject(svc)
                if why is not None:
                    raise ValueError(
                        f"arrival {svc.name!r} is not streamable ({why}): "
                        f"constrained services deploy via deploy.execute "
                        f"(docs/guide/14-streaming-admission.md)")
                if (svc.name in stream.row_of and svc.name not in
                        stream.tombstones) or svc.name in queued_names:
                    raise ValueError(
                        f"arrival {svc.name!r} already live or queued in "
                        f"{stream.key}")
                if svc.name in {s.name for s in svcs}:
                    raise ValueError(f"duplicate arrival {svc.name!r}")
                svcs.append(svc)
            deps: list[str] = []
            pending_deps = {r.name for q in self._queues.values() for r in q
                            if r.kind == "departure"
                            and r.stage_key == stream.key}
            for name in departures:
                name = str(name)
                if name in pending_deps or name in deps:
                    # a doubled departure would tombstone one row twice
                    # (double free-list entry -> one row handed to two
                    # arrivals); draining is idempotent, not cumulative
                    raise ValueError(
                        f"departure {name!r} is already pending in "
                        f"{stream.key}")
                if name not in stream.streamed:
                    # a base-flow service may carry constraint ids (or
                    # replica rows) the tombstone row would keep
                    # occupying — route its teardown through deploy.down
                    base = stream.flow.services.get(name)
                    if base is not None and _simple_reject(base):
                        raise ValueError(
                            f"departure {name!r} is a constrained base "
                            f"service; tear it down via deploy.down")
                live = (name in stream.row_of
                        and name not in stream.tombstones)
                queued = name in queued_names or any(
                    s.name == name for s in svcs)
                parked = any(r.name == name and r.stage_key == stream.key
                             for r in self._parked)
                if not (live or queued or parked):
                    raise ValueError(
                        f"departure {name!r}: no such live, queued or "
                        f"parked service in {stream.key}")
                deps.append(name)

            # tenant hard quota (policy, not backpressure): arrivals past
            # the cap's headroom PARK with reason "quota" — accepted and
            # journaled, deferred until this tenant's own departures open
            # headroom. Split BEFORE the depth watermark so a capped
            # tenant's overflow never occupies (or sheds against) the
            # shared queue bound
            quota_overflow: list[Service] = []
            headroom = self._quota_headroom(tenant)
            if headroom is not None and svcs and len(svcs) > max(headroom, 0):
                keep = max(headroom, 0)
                quota_overflow = svcs[keep:]
                svcs = svcs[:keep]

            # depth watermark (backpressure). Pure-departure submits are
            # exempt: they only ever FREE capacity — refusing them at a
            # full queue would turn transient backpressure into a stall
            # (deps are naturally bounded by the live set, so the
            # exemption cannot grow the queue without bound)
            depth = sum(len(q) for q in self._queues.values())
            incoming = len(svcs) + len(deps)
            if svcs and depth + incoming > self.cfg.max_queue:
                if self.cfg.on_full == "park":
                    result = self._park_on_full(stream, tenant, svcs, deps,
                                                now)
                else:
                    _M_SHEDS.inc(len(svcs), reason="depth")
                    self.stats["sheds"] += len(svcs)
                    raise AdmissionRejected(
                        f"queue depth {depth}+{incoming} exceeds "
                        f"{self.cfg.max_queue}", reason="queue-depth",
                        retry_after_s=max(self.cfg.drain_interval_s * 2,
                                          1.0))
            else:
                accepted = self._enqueue(stream, tenant, svcs, deps, now)
                result = {"accepted": accepted,
                          "queued": depth + incoming,
                          "stage": stream.key}
            if quota_overflow:
                ids = self._park_quota(stream, tenant, quota_overflow, now)
                result["accepted"] = list(result["accepted"]) + ids
                result["parked"] = result.get("parked", 0) + len(ids)
                result["quota_parked"] = len(ids)
            self._update_pressure(now)
            self._set_queue_gauges(now)
            return result

    def _enqueue(self, stream: _Stream, tenant: str, svcs: list[Service],
                 deps: list[str], now: float) -> list[str]:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._deficit[tenant] = 0.0
            self._rr.append(tenant)
        accepted = []
        for svc in svcs:
            r = AdmissionRequest(
                id=f"adm_{next(self._ids)}", tenant=tenant, kind="arrival",
                name=svc.name, stage_key=stream.key, submitted_at=now,
                seq=next(self._seq), service=svc,
                demand=np.array(svc.resources.as_tuple(), dtype=np.float64))
            q.append(r)
            self.requests[r.id] = r
            accepted.append(r.id)
        for name in deps:
            r = AdmissionRequest(
                id=f"adm_{next(self._ids)}", tenant=tenant,
                kind="departure", name=name, stage_key=stream.key,
                submitted_at=now, seq=next(self._seq))
            q.append(r)
            self.requests[r.id] = r
            accepted.append(r.id)
        return accepted

    def _park_on_full(self, stream: _Stream, tenant: str,
                      svcs: list[Service], deps: list[str],
                      now: float) -> dict:
        """on_full="park": accept but defer the arrivals past the depth
        bound (departures always enqueue — they free capacity)."""
        accepted = self._enqueue(stream, tenant, [], deps, now)
        for svc in svcs:
            r = AdmissionRequest(
                id=f"adm_{next(self._ids)}", tenant=tenant, kind="arrival",
                name=svc.name, stage_key=stream.key, submitted_at=now,
                seq=next(self._seq), service=svc,
                demand=np.array(svc.resources.as_tuple(), dtype=np.float64),
                state="parked")
            self.requests[r.id] = r
            self._parked.append(r)
            self._journal_park(r, "depth")
            accepted.append(r.id)
        n = len(svcs)
        if n:
            _M_PARKED.inc(n)
            self.stats["parked"] += n
        self._update_pressure(now)
        self._set_queue_gauges(now)
        return {"accepted": accepted, "queued": len(svcs) + len(deps),
                "stage": stream.key, "parked": n}

    def _park_quota(self, stream: _Stream, tenant: str,
                    svcs: list[Service], now: float) -> list[str]:
        """Park arrivals a tenant hard cap refused headroom for. Accepted
        (ids returned, journaled) but deferred: they re-queue only once
        the tenant's own live+queued count drops under its cap."""
        ids = []
        for svc in svcs:
            r = AdmissionRequest(
                id=f"adm_{next(self._ids)}", tenant=tenant, kind="arrival",
                name=svc.name, stage_key=stream.key, submitted_at=now,
                seq=next(self._seq), service=svc,
                demand=np.array(svc.resources.as_tuple(), dtype=np.float64),
                state="parked")
            self.requests[r.id] = r
            self._parked.append(r)
            self._journal_park(r, "quota")
            ids.append(r.id)
        n = len(svcs)
        _M_PARKED.inc(n)
        _M_QUOTA_PARKED.inc(n, tenant=tenant)
        self.stats["parked"] += n
        self.stats["quota_parked"] += n
        log.info("admission quota parked %s", kv(
            tenant=tenant, arrivals=n,
            cap=self.cfg.tenant_caps.get(tenant)))
        return ids

    # ------------------------------------------------------------------
    # deficit round robin (weighted tenant fairness)
    # ------------------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        return max(float(self.cfg.tenant_weights.get(tenant, 1.0)), 1e-6)

    def _next_batch(self) -> list[AdmissionRequest]:
        """One DRR scan: each non-empty tenant queue earns quantum*weight
        credit per visit and pops whole requests against it — weighted
        max-min fair service, so a flooding tenant drains at its weight's
        share while light tenants drain completely."""
        batch: list[AdmissionRequest] = []
        if not self._rr:
            return batch
        n = len(self._rr)
        idle_visits = 0
        i = self._rr_idx
        while len(batch) < self.cfg.batch_max and idle_visits < n:
            tenant = self._rr[i % n]
            i += 1
            q = self._queues.get(tenant)
            if not q:
                self._deficit[tenant] = 0.0
                idle_visits += 1
                continue
            self._deficit[tenant] = (self._deficit.get(tenant, 0.0)
                                     + self.cfg.quantum
                                     * self._weight(tenant))
            popped = False
            while (q and self._deficit[tenant] >= 1.0
                   and len(batch) < self.cfg.batch_max):
                batch.append(q.popleft())
                self._deficit[tenant] -= 1.0
                popped = True
            if not q:
                self._deficit[tenant] = 0.0
            idle_visits = 0 if popped else idle_visits + 1
        self._rr_idx = i % n
        for tenant in self._rr:
            _M_DEBT.set(self._deficit.get(tenant, 0.0), tenant=tenant)
        return batch

    # ------------------------------------------------------------------
    # the drain pass
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        with self._lock:
            # parked arrivals whose capacity epoch moved are pending a
            # retry — real work; parked-with-unchanged-epoch is not (no
            # hot loop on a standing infeasibility)
            return (any(self._queues.values())
                    or (bool(self._parked)
                        and self._park_epoch != self._capacity_epoch))

    def step(self, now: Optional[float] = None) -> dict:
        """One drain pass: retry parked if capacity moved, shed the aged
        tail, pop one DRR batch, fold + micro-solve + commit per stage.
        Returns a summary for callers that narrate (chaos runner, tests)."""
        with self._lock:
            now = self.clock() if now is None else now
            t_drain = time.perf_counter()
            self._retry_parked()
            self._shed_aged(now)
            batch = self._next_batch()
            drain_ms = (time.perf_counter() - t_drain) * 1e3
            summary = {"batch": len(batch), "placed": [], "departed": [],
                       "parked": [], "stages": [], "violations": 0,
                       "solve_ms": 0.0, "shed": 0,
                       "phase_ms": {"drain": drain_ms, "fold": 0.0,
                                    "solve": 0.0, "commit": 0.0}}
            if not batch:
                self._update_pressure(now)
                self._set_queue_gauges(now)
                return summary
            self.stats["batches"] += 1
            _M_BATCH.observe(len(batch))
            _M_BATCH_AGE.observe(now - min(r.submitted_at for r in batch))
            by_stage: dict[str, list[AdmissionRequest]] = {}
            for r in batch:
                by_stage.setdefault(r.stage_key, []).append(r)
            for key in sorted(by_stage):
                stream = self._streams[key]
                self._resync(stream)
                out = self._micro_solve(stream, by_stage[key], now)
                summary["placed"] += out["placed"]
                summary["departed"] += out["departed"]
                summary["parked"] += out["parked"]
                summary["violations"] = max(summary["violations"],
                                            out["violations"])
                summary["solve_ms"] += out["solve_ms"]
                for ph, ms in out.get("phase_ms", {}).items():
                    summary["phase_ms"][ph] += ms
                if out["placed"] or out["departed"]:
                    summary["stages"].append(key)
            for ph, ms in summary["phase_ms"].items():
                _M_PHASE.observe(ms, phase=ph)
                self.last_phase_ms[ph] = round(ms, 3)
            self._update_pressure(now)
            self._set_queue_gauges(now)
            return summary

    def _shed_aged(self, now: float) -> None:
        """Age watermark: a queued request older than shed_age_s is shed
        (terminal, counted) — the queue can never grow a stale tail the
        client believes is still pending. Departures are exempt: they
        only ever FREE capacity and must eventually apply."""
        if self.cfg.shed_age_s <= 0:
            return
        for tenant in sorted(self._queues):
            q = self._queues[tenant]
            keep: deque[AdmissionRequest] = deque()
            for r in q:
                # quota-marked arrivals are exempt: their age is the cap
                # wait the controller itself imposed when it ACCEPTED
                # them — shedding them on requeue would betray that
                if (r.kind == "arrival" and r.park_reason != "quota"
                        and now - r.submitted_at > self.cfg.shed_age_s):
                    r.state, r.done_at = "shed", now
                    _M_SHEDS.inc(reason="age")
                    self.stats["sheds"] += 1
                else:
                    keep.append(r)
            self._queues[tenant] = keep

    def _retry_parked(self) -> None:
        """Parked arrivals re-queue (front, original order) once capacity
        has plausibly moved: a departure committed or a stream resynced
        since the park. Epoch-gated so an infeasible arrival cannot
        hot-loop a solve every drain pass. Quota parks additionally need
        tenant HEADROOM — a capacity epoch bump from some other tenant's
        departure must not tunnel a capped tenant past its cap — and a
        request whose stage is not (yet) re-attached stays parked, so a
        freshly promoted CP cannot KeyError a restored arrival."""
        if not self._parked or self._park_epoch == self._capacity_epoch:
            return
        self._park_epoch = self._capacity_epoch
        parked, self._parked = self._parked, []
        # headroom with the parked set swapped OUT: cap - (live + queued).
        # Every arrival we keep or requeue re-occupies one slot below.
        headroom: dict[str, Optional[int]] = {
            t: self._quota_headroom(t)
            for t in {r.tenant for r in parked}}
        requeue: list[AdmissionRequest] = []
        for r in sorted(parked, key=lambda r: r.seq):
            if r.stage_key not in self._streams:
                self._parked.append(r)
                if headroom.get(r.tenant) is not None:
                    headroom[r.tenant] -= 1
                continue
            h = headroom.get(r.tenant)
            if r.park_reason == "quota" and h is not None and h <= 0:
                self._parked.append(r)
                continue
            if h is not None:
                headroom[r.tenant] = h - 1
            requeue.append(r)
        for r in sorted(requeue, key=lambda r: r.seq, reverse=True):
            r.state = "queued"
            # a quota park KEEPS its marker through the requeue: its wait
            # includes policy-imposed cap time, which must not pollute
            # the fairness/SLO wait surfaces when it finally places
            if r.park_reason != "quota":
                r.park_reason = None
            self._unjournal_park(r)
            q = self._queues.get(r.tenant)
            if q is None:
                q = self._queues[r.tenant] = deque()
                self._deficit[r.tenant] = 0.0
                self._rr.append(r.tenant)
            q.appendleft(r)
        n = len(requeue)
        if n:
            _M_UNPARKED.inc(n)
            self.stats["unparked"] += n

    # ------------------------------------------------------------------
    # folding a batch into the streaming problem
    # ------------------------------------------------------------------

    def _fold(self, stream: _Stream, events: list[AdmissionRequest]):
        """Fold events (submission order) into a CANDIDATE problem built
        from the stream's current pt by dataclasses.replace — the delta
        shape the resident staging recognizes. Returns (pt2, delta,
        row_plan) without mutating the stream; commit applies row_plan."""
        pt = stream.pt
        S, N = pt.S, pt.N
        R = pt.demand.shape[1]
        events = sorted(events, key=lambda r: r.seq)
        free = list(stream.free_rows)
        appended: list[AdmissionRequest] = []
        # (row, request, departed name the row previously carried)
        reuse: list[tuple[int, AdmissionRequest, str]] = []
        tomb_rows: list[tuple[int, str]] = []
        cancelled: list[AdmissionRequest] = []
        placed_in_batch: dict[str, AdmissionRequest] = {}
        for r in events:
            if r.kind == "arrival":
                if free:
                    row = free.pop(0)
                    reuse.append((row, r, pt.service_names[row]))
                else:
                    appended.append(r)
                placed_in_batch[r.name] = r
            else:
                if r.name in placed_in_batch:
                    # departure of an arrival in the SAME batch: both
                    # cancel out before ever touching the problem
                    a = placed_in_batch.pop(r.name)
                    if a in appended:
                        appended.remove(a)
                    else:
                        for j, (row, req, _old) in enumerate(reuse):
                            if req is a:
                                free.insert(0, row)
                                del reuse[j]
                                break
                    cancelled.append(a)
                    cancelled.append(r)
                    continue
                if any(name == r.name for _row, name in tomb_rows):
                    # doubled departure (validation guards this; a race
                    # must still never double-free the row)
                    cancelled.append(r)
                    continue
                row = stream.row_of[r.name]
                tomb_rows.append((row, r.name))
                free.append(row)

        k_app = len(appended)
        S2 = S + k_app
        names = list(pt.service_names)
        if k_app:
            demand = np.vstack([pt.demand,
                                np.zeros((k_app, R), dtype=pt.demand.dtype)])
            eligible = np.vstack([pt.eligible,
                                  np.zeros((k_app, N), dtype=bool)])
            dep_adj = np.zeros((S2, S2), dtype=bool)
            dep_adj[:S, :S] = pt.dep_adj
            dep_depth = np.concatenate(
                [pt.dep_depth, np.zeros(k_app, dtype=pt.dep_depth.dtype)])
            ids = {}
            for f in ("port_ids", "volume_ids", "anti_ids", "coloc_ids"):
                old = getattr(pt, f)
                ids[f] = np.vstack([old, np.full((k_app, old.shape[1]), -1,
                                                 dtype=old.dtype)])
            replica_of = list(pt.replica_of) + [r.name for r in appended]
        else:
            demand = pt.demand.copy()
            eligible = pt.eligible.copy() if reuse else pt.eligible
            dep_adj, dep_depth = pt.dep_adj, pt.dep_depth
            ids = {f: getattr(pt, f) for f in
                   ("port_ids", "volume_ids", "anti_ids", "coloc_ids")}
            replica_of = pt.replica_of

        changed_rows: list[int] = []
        elig_rows: list[int] = []
        node_index = {n: j for j, n in enumerate(pt.node_names)}

        def elig_mask(r: AdmissionRequest) -> np.ndarray:
            if not r.eligible_nodes:
                return np.ones(N, dtype=bool)
            mask = np.zeros(N, dtype=bool)
            for n in r.eligible_nodes:
                j = node_index.get(n)
                if j is not None:
                    mask[j] = True
            return mask

        for row, name in tomb_rows:
            demand[row] = 0.0
            changed_rows.append(row)
        for row, r, _old in reuse:
            demand[row] = r.demand
            eligible[row] = elig_mask(r)
            names[row] = r.name
            changed_rows.append(row)
            elig_rows.append(row)
        for j, r in enumerate(appended):
            row = S + j
            demand[row] = r.demand
            eligible[row] = elig_mask(r)
            names.append(r.name)
            changed_rows.append(row)
            elig_rows.append(row)

        if not changed_rows and not cancelled:
            return None, None, None
        rows = np.asarray(sorted(set(changed_rows)), dtype=np.int32)
        erows = np.asarray(sorted(set(elig_rows)), dtype=np.int32)
        # always carry BOTH scatter planes (possibly empty), as the
        # reference does: one delta shape at steady state
        delta = ProblemDelta(
            demand_rows=(rows, demand[rows]),
            eligible_rows=(erows, eligible[erows]),
            n_real=S2 if k_app else None)
        pt2 = _dc_replace(pt, demand=demand, eligible=eligible,
                          dep_adj=dep_adj, dep_depth=dep_depth,
                          service_names=names, replica_of=replica_of,
                          **ids)
        plan = {"appended": appended, "reuse": reuse,
                "tomb_rows": tomb_rows, "free": free,
                "cancelled": cancelled,
                "events": [r for r in events if r not in cancelled]}
        return pt2, delta, plan

    def _should_compact(self, stream: _Stream, n_new: int) -> bool:
        """Compact (drop tombstone rows, cold-restage once) before a
        growth that would cross the padded shape tier while reclaimable
        rows exist — trading one counted restage for keeping the steady
        state inside one staging."""
        if not stream.free_rows:
            return False
        cfg = bucket_config()
        if not cfg.enabled:
            return len(stream.free_rows) * 4 >= stream.pt.S
        cur = bucket_size(stream.pt.S, growth=cfg.growth,
                          minimum=cfg.minimum, align=cfg.align)
        grown = bucket_size(stream.pt.S + n_new, growth=cfg.growth,
                            minimum=cfg.minimum, align=cfg.align)
        return grown != cur

    def _compact(self, stream: _Stream) -> None:
        """Drop the reclaimable tombstone rows (exactly the free list:
        every tombstoned-but-not-reused row) from the streaming problem.
        The next solve cold-stages (new shapes) — amortized and counted."""
        pt = stream.pt
        drop = set(stream.free_rows)
        keep = np.asarray([i for i in range(pt.S) if i not in drop],
                          dtype=np.int64)
        names = [pt.service_names[i] for i in keep]
        stream.pt = _dc_replace(
            pt,
            demand=pt.demand[keep],
            eligible=pt.eligible[keep],
            dep_adj=pt.dep_adj[np.ix_(keep, keep)],
            dep_depth=pt.dep_depth[keep],
            port_ids=pt.port_ids[keep],
            volume_ids=pt.volume_ids[keep],
            anti_ids=pt.anti_ids[keep],
            coloc_ids=pt.coloc_ids[keep],
            service_names=names,
            replica_of=[pt.replica_of[i] for i in keep]
            if pt.replica_of else pt.replica_of)
        stream.row_of = {n: i for i, n in enumerate(names)}
        stream.tombstones = set()
        stream.free_rows = []
        self.stats["compactions"] += 1
        log.info("admission stream compacted %s",
                 kv(stage=stream.key, dropped=len(drop), rows=len(keep)))

    def _micro_solve(self, stream: _Stream, events: list[AdmissionRequest],
                     now: float) -> dict:
        """One bucketed micro-solve: fold the events, solve through the
        resident delta path, commit as ONE reservation. Infeasible:
        departures re-apply alone (they strictly free capacity) and the
        arrivals PARK for retry when capacity moves."""
        out = {"placed": [], "departed": [], "parked": [], "violations": 0,
               "solve_ms": 0.0,
               "phase_ms": {"fold": 0.0, "solve": 0.0, "commit": 0.0}}
        # a departure whose arrival has not landed yet: cancel a PARKED
        # arrival in place, defer one still queued (its arrival sits ahead
        # of it in FIFO order, so the retry resolves next pass)
        batch_arrivals = {r.name for r in events if r.kind == "arrival"}
        kept: list[AdmissionRequest] = []
        for r in sorted(events, key=lambda r: r.seq):
            if (r.kind == "departure" and r.name not in stream.row_of
                    and r.name not in batch_arrivals):
                parked = next(
                    (p for p in self._parked
                     if p.name == r.name and p.stage_key == stream.key),
                    None)
                if parked is not None:
                    self._parked.remove(parked)
                    parked.state, parked.done_at = "cancelled", now
                    self._unjournal_park(parked)
                    r.state, r.done_at = "departed", now
                    out["departed"].append(r.name)
                elif any(q2.name == r.name and q2.kind == "arrival"
                         for q in self._queues.values() for q2 in q):
                    # its arrival is still queued behind it: retry next
                    # pass (FIFO guarantees the arrival pops first)
                    self._queues[r.tenant].appendleft(r)
                else:
                    # target is gone (already departed, shed, or never
                    # existed): the goal state holds — terminal, not a
                    # forever-spinning requeue
                    r.state, r.done_at = "cancelled", now
                continue
            kept.append(r)
        events = kept
        if not events:
            return out
        t_fold = time.perf_counter()
        n_app = sum(1 for r in events if r.kind == "arrival")
        if self._should_compact(stream, max(n_app - len(stream.free_rows),
                                            0)):
            self._compact(stream)
        folded = self._fold(stream, events)
        out["phase_ms"]["fold"] += (time.perf_counter() - t_fold) * 1e3
        pt2, delta, plan = folded
        if plan is None:
            return out
        for r in plan["cancelled"]:
            r.state = "cancelled" if r.kind == "arrival" else "departed"
            r.done_at = now
        if not plan["events"]:
            return out

        t0 = time.perf_counter()
        masked = (stream.tombstones
                  | {name for _row, name in plan["tomb_rows"]})
        placement, rid, pt_used = self.placement.admit_batch(
            stream.key, pt2, delta, tenant=stream.tenant, masked=masked)
        wall_ms = (time.perf_counter() - t0) * 1e3
        out["solve_ms"] = wall_ms
        out["phase_ms"]["solve"] += wall_ms
        # ONE sample per micro-solve: the p50/p99 surface measures the
        # solver tail, not how many stage streams a drain batch fanned to
        self.solve_ms_samples.append(wall_ms)
        slo_observe("admission_solve_ms", wall_ms)
        out["violations"] = placement.violations
        self.stats["solves"] += 1

        if placement.feasible and rid:
            t_commit = time.perf_counter()
            self.placement.commit(rid)
            _M_SOLVES.inc(outcome="committed")
            self._commit_plan(stream, pt_used, plan, now, out)
            out["phase_ms"]["commit"] += \
                (time.perf_counter() - t_commit) * 1e3
            if wall_ms > 0:
                _M_RATE.set(len(out["placed"]) / (wall_ms / 1e3))
            return out

        _M_SOLVES.inc(outcome="infeasible")
        if rid:
            self.placement.release(rid)
        arrivals = [r for r in plan["events"] if r.kind == "arrival"]
        departures = [r for r in plan["events"] if r.kind == "departure"]
        for r in arrivals:
            r.state = "parked"
            self._parked.append(r)
            self._journal_park(r, "capacity")
        if arrivals:
            _M_PARKED.inc(len(arrivals))
            self.stats["parked"] += len(arrivals)
            log.warning("admission parked %s", kv(
                stage=stream.key, arrivals=len(arrivals),
                violations=placement.violations))
        out["parked"] = [r.name for r in arrivals]
        if departures:
            # strictly capacity-freeing — re-fold without the arrivals
            t_fold = time.perf_counter()
            pt3, delta3, plan3 = self._fold(stream, departures)
            out["phase_ms"]["fold"] += (time.perf_counter() - t_fold) * 1e3
            if plan3 is not None and plan3["events"]:
                masked3 = (stream.tombstones
                           | {n for _row, n in plan3["tomb_rows"]})
                t_solve = time.perf_counter()
                placement3, rid3, pt_used3 = self.placement.admit_batch(
                    stream.key, pt3, delta3, tenant=stream.tenant,
                    masked=masked3)
                solve3_ms = (time.perf_counter() - t_solve) * 1e3
                out["phase_ms"]["solve"] += solve3_ms
                self.solve_ms_samples.append(solve3_ms)
                slo_observe("admission_solve_ms", solve3_ms)
                if placement3.feasible and rid3:
                    t_commit = time.perf_counter()
                    self.placement.commit(rid3)
                    _M_SOLVES.inc(outcome="committed")
                    self._commit_plan(stream, pt_used3, plan3, now, out)
                    out["phase_ms"]["commit"] += \
                        (time.perf_counter() - t_commit) * 1e3
                    return out
                if rid3:
                    self.placement.release(rid3)
                # cannot even apply departures: requeue them untouched
                for r in sorted(departures, key=lambda r: r.seq,
                                reverse=True):
                    self._queues[r.tenant].appendleft(r)
        return out

    def _commit_plan(self, stream: _Stream, pt_used, plan: dict,
                     now: float, out: dict) -> None:
        """The micro-solve committed: apply the row plan to the stream
        book and the flow (so redeploys/teardowns see streamed truth),
        mark the requests terminal, record waits."""
        stream.pt = pt_used
        stage = stream.flow.stage(stream.stage_name)
        freed_capacity = False
        for row, name in plan["tomb_rows"]:
            stream.tombstones.add(name)
            del stream.row_of[name]
            stream.streamed.pop(name, None)
            tenant = stream.owner.pop(name, None)
            if name in stream.flow.services:
                del stream.flow.services[name]
            if name in stage.services:
                stage.services.remove(name)
            freed_capacity = True
            if tenant is not None:
                _M_DEPARTED.inc(tenant=tenant)
        stream.free_rows = plan["free"]
        for row, r, old_name in plan["reuse"]:
            # the row was renamed by _fold: its previous (departed)
            # occupant leaves the tombstone mask with it
            stream.tombstones.discard(old_name)
            stream.row_of[r.name] = row
        for j, r in enumerate(plan["appended"]):
            stream.row_of[r.name] = stream.pt.S - len(plan["appended"]) + j
        for r in plan["events"]:
            if r.kind == "arrival":
                r.state, r.done_at = "placed", now
                stream.streamed[r.name] = r.seq
                stream.owner[r.name] = r.tenant
                stream.flow.services[r.name] = r.service
                stage.services.append(r.name)
                _M_ADMITTED.inc(tenant=r.tenant)
                self.stats["admitted"] += 1
                if r.park_reason != "quota":
                    # quota-parked waits are policy (the tenant sat at
                    # its purchased cap), not scheduler service time —
                    # they must not pollute the fairness percentiles or
                    # the admission-wait SLO stream
                    _M_WAIT.observe(now - r.submitted_at)
                    samples = self.wait_samples.setdefault(
                        r.tenant, deque(maxlen=4096))
                    samples.append(now - r.submitted_at)
                    # admission-wait SLO stream: submit → committed
                    # placement on the engine's clock (virtual in chaos)
                    slo_observe("admission_wait_s", now - r.submitted_at)
                out["placed"].append(r.name)
            else:
                r.state, r.done_at = "departed", now
                self.stats["departed"] += 1
                out["departed"].append(r.name)
        if freed_capacity:
            self._capacity_epoch += 1

    # ------------------------------------------------------------------
    # feedback + introspection
    # ------------------------------------------------------------------

    def _queue_ages(self, now: float) -> tuple[int, float]:
        depth, oldest = 0, 0.0
        for q in self._queues.values():
            depth += len(q)
            if q:
                oldest = max(oldest, now - q[0].submitted_at)
        return depth, oldest

    def _update_pressure(self, now: float) -> None:
        depth, oldest = self._queue_ages(now)
        # quota parks are EXCLUDED from pressure: provisioning nodes
        # cannot raise a tenant's purchased cap, so counting them would
        # hold the autoscaler hot (and block idle scale-down) forever
        hard_parked = sum(1 for r in self._parked
                          if r.park_reason != "quota")
        hot = (depth > 0 and oldest >= self.cfg.pressure_age_s) \
            or bool(hard_parked)
        if hot:
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
        self._pressure_snapshot = {
            "queue_depth": depth,
            "oldest_age_s": round(oldest, 3),
            "parked": len(self._parked),
            "parked_quota": len(self._parked) - hard_parked,
            "sustained": (self._pressure_since is not None
                          and now - self._pressure_since
                          >= self.cfg.pressure_sustain_s),
            "drained": depth == 0 and hard_parked == 0}

    def _set_queue_gauges(self, now: float) -> None:
        depth, oldest = self._queue_ages(now)
        _M_DEPTH.set(depth)
        _M_OLDEST.set(oldest)

    def pressure(self) -> dict:
        """The autoscaler's solver-pressure input (cp/autoscaler.py):
        sustained queue age or infeasible-parked arrivals say 'provision';
        a drained queue says 'normal idle rules apply'. Lock-free read of
        the last submit/step's snapshot — the feedback must not block on
        a drain pass's solver wall time."""
        return dict(self._pressure_snapshot)

    def live_names(self, stage_key: str) -> list[str]:
        """Currently-live streamed services of a stage (the chaos
        admission-converged invariant cross-checks these against the
        committed placement)."""
        with self._lock:
            stream = self._streams.get(stage_key)
            if stream is None:
                return []
            return sorted(stream.streamed)

    def streamed_names(self, tenant: str,
                       stage: Optional[str] = None) -> list[str]:
        """Live streamed services owned by `tenant`, oldest first — what
        a departure generator drains. Names with a departure already
        queued are excluded: draining is idempotent, not cumulative."""
        with self._lock:
            pending = {r.name for q in self._queues.values() for r in q
                       if r.kind == "departure"}
            out = []
            for key, stream in sorted(self._streams.items()):
                if stage is not None and key != stage:
                    continue
                out += [(seq, n) for n, seq in stream.streamed.items()
                        if stream.owner.get(n) == tenant
                        and n not in pending]
            return [n for _seq, n in sorted(out)]

    def queue_census(self) -> dict:
        """Per-tenant (queued, oldest_age_s) plus totals — the cheap
        slice of status() the obs collector deep-samples every tick:
        no percentile math, no stream walk, one short lock hold."""
        with self._lock:
            now = self.clock()
            depth, oldest = self._queue_ages(now)
            tenants = {t: {"queued": len(q),
                           "oldest_age_s": now - q[0].submitted_at}
                       for t, q in self._queues.items() if q}
            return {"queue_depth": depth, "oldest_age_s": oldest,
                    "parked": len(self._parked), "tenants": tenants}

    def status(self) -> dict:
        """The `fleet admit status` / deploy.admit_status payload."""
        with self._lock:
            now = self.clock()
            depth, oldest = self._queue_ages(now)
            tenants = {}
            for tenant in sorted(set(self._rr) | set(self.wait_samples)
                                 | set(self.cfg.tenant_caps)
                                 | {r.tenant for r in self._parked}):
                q = self._queues.get(tenant) or ()
                waits = self.wait_samples.get(tenant) or ()
                cap = self.cfg.tenant_caps.get(tenant)
                tenants[tenant] = {
                    "queued": len(q),
                    "oldest_age_s": round(now - q[0].submitted_at, 3)
                    if q else 0.0,
                    "weight": self._weight(tenant),
                    "deficit": round(self._deficit.get(tenant, 0.0), 2),
                    "wait_p50_s": round(float(np.percentile(
                        list(waits), 50)), 3) if waits else None,
                    "wait_p99_s": round(float(np.percentile(
                        list(waits), 99)), 3) if waits else None,
                    # hard-quota surface (`fleet admit status`): usage is
                    # everything the cap counts — live + queued + parked
                    "live": sum(1 for s in self._streams.values()
                                for t in s.owner.values() if t == tenant),
                    "usage": self._tenant_inflight(tenant),
                    "cap": cap,
                    "parked_quota": sum(
                        1 for r in self._parked
                        if r.tenant == tenant
                        and r.park_reason == "quota"),
                }
            streams = {key: {"rows": s.pt.S,
                             "live_streamed": len(s.streamed),
                             "tombstones": len(s.tombstones),
                             "free_rows": len(s.free_rows)}
                       for key, s in sorted(self._streams.items())}
            return {"enabled": True,
                    "queue_depth": depth,
                    "oldest_age_s": round(oldest, 3),
                    "parked": len(self._parked),
                    "parked_quota": sum(1 for r in self._parked
                                        if r.park_reason == "quota"),
                    "tenants": tenants,
                    "streams": streams,
                    "pressure": {
                        "sustained": (self._pressure_since is not None
                                      and now - self._pressure_since
                                      >= self.cfg.pressure_sustain_s),
                        "since_s": round(now - self._pressure_since, 3)
                        if self._pressure_since is not None else None},
                    "stats": dict(self.stats),
                    # last non-empty drain pass, by phase — attribute a
                    # p99 solve tail without attaching a profiler
                    "solve_phases_ms": dict(self.last_phase_ms),
                    # the micro-solve tail over the sample window: the
                    # number the active-set path (solver/subsolve.py)
                    # exists to keep flat
                    "solve_ms_p50": round(float(np.percentile(
                        list(self.solve_ms_samples), 50)), 2)
                    if self.solve_ms_samples else None,
                    "solve_ms_p99": round(float(np.percentile(
                        list(self.solve_ms_samples), 99)), 2)
                    if self.solve_ms_samples else None,
                    # how the micro-solves were dispatched (the metrics
                    # existed; this is where operators actually look):
                    # localized = active-set mini anneal committed by the
                    # exact gate, fallback_* = the full path ran and why
                    "subsolve": subsolve_outcomes(),
                    "config": {"max_queue": self.cfg.max_queue,
                               "shed_age_s": self.cfg.shed_age_s,
                               "on_full": self.cfg.on_full,
                               "batch_max": self.cfg.batch_max,
                               "quantum": self.cfg.quantum,
                               "weights": dict(self.cfg.tenant_weights),
                               "tenant_caps": dict(self.cfg.tenant_caps)}}

    # ------------------------------------------------------------------
    # background drain loop (production; chaos/bench call step() directly)
    # ------------------------------------------------------------------

    async def run_loop(self) -> None:
        while True:
            try:
                if self.has_work():
                    await asyncio.get_running_loop().run_in_executor(
                        None, self.step)
            except Exception as e:
                # a fault of the device path itself ends the task with it:
                # retrying around a missing card or a broken kernel would
                # stall admissions behind log lines
                if _device_fault(e):
                    raise
                log.exception("admission drain pass failed")
            await asyncio.sleep(self.cfg.drain_interval_s)

    def spawn(self) -> None:
        self._task = asyncio.ensure_future(self.run_loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
