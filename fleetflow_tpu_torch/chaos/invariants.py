"""Fleet-wide invariants: what must hold no matter which faults fired.

The port's copy of ``fleetflow_tpu/chaos/invariants.py``.

Each checker takes the chaos world (duck-typed: `state` AppState, `flow`,
`stage_keys`, `backends` slug->MockBackend, `clock`) and returns a list
of violation strings — empty means the invariant holds. The runner calls
the *instant* checkers after every applied fault burst (single-threaded
replay means every mutation happens between two check points, so
per-burst checking is "at any instant") and the *final* checkers once
the world settles.

Every checker has a deliberately-broken-world canary test
(tests/test_chaos.py, tests/test_torch_chaos.py) proving it actually fires — a chaos harness whose
invariants are vacuously green is worse than no harness.
"""

from __future__ import annotations

import numpy as np

__all__ = ["INSTANT_INVARIANTS", "FINAL_INVARIANTS", "check_instant",
           "check_final", "capacity_accounting", "reservations_terminal",
           "no_dead_assignments", "pools_at_min", "solver_feasible",
           "containers_converged", "metrics_monotonic",
           "agents_gauge_consistent", "selfheal_converged",
           "cp_failover_converged", "admission_fair",
           "admission_converged", "admission_quota", "slo_met",
           "record_outage_census", "degraded_gracefully"]

_EPS = 1e-6


def _alloc_vec(s) -> np.ndarray:
    a = s.allocated
    return np.array([a.cpu + a.reserved_cpu, a.memory + a.reserved_memory,
                     a.disk + a.reserved_disk], dtype=np.float64)


def capacity_accounting(world) -> list[str]:
    """No node is ever double-booked: committed allocation plus every
    in-flight reservation's demand stays within raw capacity (the 2-phase
    journal's whole reason to exist, SURVEY hard part (c))."""
    out: list[str] = []
    snap = world.state.placement.reservations_snapshot()
    inflight: dict[str, np.ndarray] = {}
    for r in snap["in_flight"]:
        for slug, dem in r["demand_by_node"].items():
            inflight[slug] = (inflight.get(slug, 0)
                              + np.asarray(dem, dtype=np.float64))
    for s in sorted(world.state.store.list("servers"), key=lambda s: s.slug):
        cap = np.array([s.capacity.cpu, s.capacity.memory, s.capacity.disk],
                       dtype=np.float64)
        spoken = _alloc_vec(s) + inflight.get(s.slug, 0)
        if np.any(spoken > cap * (1 + _EPS) + _EPS):
            out.append(
                f"capacity double-booked on {s.slug}: "
                f"committed+reserved={np.round(spoken, 3).tolist()} > "
                f"capacity={cap.tolist()}")
    return out


def reservations_terminal(world) -> list[str]:
    """Every reservation reached a terminal state: committed or released.
    A settled world has NO in-flight reservations — a leftover one is
    capacity leaked forever (or a churn hold whose redeploy never came)."""
    snap = world.state.placement.reservations_snapshot()
    return [f"reservation {r['id']} for {r['stage']} still in flight "
            f"(churn={r['churn']}) after settle"
            for r in snap["in_flight"]]


def no_dead_assignments(world, snapshot=None) -> list[str]:
    """After churn re-solves settle, no service row is assigned to a node
    that is offline or unschedulable."""
    out: list[str] = []
    by_slug = {s.slug: s for s in world.state.store.list("servers")}
    if snapshot is None:
        snapshot = world.state.placement.snapshot()
    for key, view in sorted(snapshot.items()):
        if not view["feasible"]:
            out.append(f"stage {key} settled infeasible "
                       f"({view['violations']} violations)")
            continue
        for row, node in sorted(view["assignment"].items()):
            s = by_slug.get(node)
            if s is None:
                out.append(f"{key}: {row} assigned to vanished node {node}")
            elif not s.schedulable:
                out.append(f"{key}: {row} assigned to dead node {node} "
                           f"(status={s.status}, "
                           f"state={s.scheduling_state})")
    return out


def pools_at_min(world) -> list[str]:
    """The autoscaler held every worker pool at its floor: at least
    min_servers members alive (online, or provisioning and younger than
    the zombie timeout)."""
    from ..cp.autoscaler import PROVISION_TIMEOUT_S
    out: list[str] = []
    now = world.clock.now()
    for pool in world.state.store.list("worker_pools"):
        members = world.state.store.list(
            "servers", lambda s: s.pool == pool.name
            and s.tenant == pool.tenant)
        alive = [s for s in members
                 if s.status == "online"
                 or (s.status == "provisioning"
                     and now - s.created_at < PROVISION_TIMEOUT_S)]
        if len(alive) < pool.min_servers:
            out.append(f"pool {pool.name} below floor: {len(alive)} alive "
                       f"< min_servers={pool.min_servers}")
    return out


def solver_feasible(world) -> list[str]:
    """The final assignment is exactly feasible per the solver's own
    checker (solver/repair.verify): zero capacity/conflict/eligibility/
    skew violations against the stage's retained problem."""
    from ..solver.repair import verify
    out: list[str] = []
    for key in world.stage_keys:
        entry = world.state.placement.retained(key)
        if entry is None:
            out.append(f"stage {key}: no retained placement to verify")
            continue
        pt, placement = entry
        if placement.raw is None:
            out.append(f"stage {key}: placement has no raw assignment")
            continue
        stats = verify(pt, np.asarray(placement.raw))
        if stats["total"] != 0:
            out.append(f"stage {key}: solver checker found violations "
                       f"{stats}")
    return out


def containers_converged(world, snapshot=None) -> list[str]:
    """Desired == observed: every service row of every stage's settled
    assignment has its container RUNNING on the assigned node's backend
    (crashed/exited containers were restarted or redeployed)."""
    from ..runtime.converter import container_name
    out: list[str] = []
    if snapshot is None:
        snapshot = world.state.placement.snapshot()
    for key, view in sorted(snapshot.items()):
        if not view["feasible"]:
            continue   # reported by no_dead_assignments
        stage_name = key.split("/", 1)[1]
        for row, node in sorted(view["assignment"].items()):
            base, _, ridx = row.partition("#")
            cname = container_name(world.flow.name, stage_name, base)
            if ridx:
                cname = f"{cname}-{ridx}"
            backend = world.backends.get(node)
            if backend is None:
                out.append(f"{key}: {row} on {node} which has no backend")
                continue
            info = backend.inspect(cname)
            if info is None or not info.running:
                state = "missing" if info is None else info.state
                out.append(f"{key}: container {cname} on {node} is {state}")
    return out


def selfheal_converged(world, snapshot=None) -> list[str]:
    """Self-healing liveness: once churn quiesces (the settle loop keeps
    advancing the clock until the reconverger drains), every NON-PARKED
    service is assigned to a live node, and no redelivery debt remains.
    Parked stages are the reconverger's EXPLICIT admission that capacity
    is missing — anything else still on a dead node means the heal loop
    silently dropped work."""
    rc = getattr(world.state, "reconverger", None)
    if rc is None:
        return []
    out: list[str] = []
    parked = set(rc.parked_stage_keys())
    if snapshot is None:
        snapshot = world.state.placement.snapshot()
    by_slug = {s.slug: s for s in world.state.store.list("servers")}
    for key, view in sorted(snapshot.items()):
        if key in parked:
            continue
        if not view["feasible"]:
            out.append(f"non-parked stage {key} settled infeasible "
                       f"({view['violations']} violations) — the "
                       f"reconverger should have parked it")
            continue
        for row, node in sorted(view["assignment"].items()):
            s = by_slug.get(node)
            if s is None or not s.schedulable:
                out.append(f"{key}: {row} assigned to dead node {node} "
                           f"and the stage is not parked")
    for key in rc.pending_stage_keys():
        out.append(f"redelivery debt for {key} outstanding after settle")
    return out


def cp_failover_converged(world, snapshot=None) -> list[str]:
    """Control-plane failover safety (docs/guide/13-cp-replication.md):
    after every primary kill + settle, nothing the dead primary owed the
    fleet may be lost. Concretely:

      * the fencing epoch advanced exactly once per failover, and every
        zombie write from a dead primary was refused (fenced);
      * every convergence-debt row (parked_work) the dead primary had
        persisted either converged under the new primary or is still
        explicitly parked — never silently dropped;
      * no idempotency-keyed redelivery executed more than once on any
        agent — the dedupe windows survived the re-home.

    Liveness (every non-parked service on a live node, zero redelivery
    debt) is judged by `selfheal-converged` against the SAME world — the
    promoted primary simply has to pass the standard bar."""
    failovers = getattr(world, "cp_failovers", 0)
    if not failovers:
        return []
    out: list[str] = []
    epoch = world.state.store.epoch
    if epoch != 1 + failovers:
        out.append(f"fencing epoch {epoch} after {failovers} failovers "
                   f"(expected {1 + failovers}): a promotion skipped or "
                   f"repeated its epoch bump")
    if world.fencing_rejections < failovers:
        out.append(f"only {world.fencing_rejections} fenced zombie writes "
                   f"for {failovers} failovers: a dead primary wrote "
                   f"through the fence")
    rc = getattr(world.state, "reconverger", None)
    parked_now = set(rc.parked_stage_keys()) if rc is not None else set()
    if snapshot is None:
        snapshot = world.state.placement.snapshot()
    by_slug = {s.slug: s for s in world.state.store.list("servers")}
    for key, _was_parked in sorted(world.prekill_work):
        if key in parked_now:
            continue
        view = snapshot.get(key)
        converged = (view is not None and view["feasible"] and all(
            by_slug.get(n) is not None and by_slug[n].schedulable
            for n in view["assignment"].values()))
        if not converged:
            out.append(f"convergence debt for {key} lost across failover: "
                       f"neither converged nor parked on the new primary")
    for _key, (stage, runs) in sorted(world.idem_executions.items()):
        if runs > 1:
            out.append(f"idempotency window lost: a keyed redelivery for "
                       f"{stage} executed {runs} times")
    return out


ADMISSION_FAIR_K = 4.0           # tenant p99 wait <= K x fleet median
ADMISSION_FAIR_FLOOR_S = 30.0    # ... with a pacing-granularity floor


def admission_fair(world) -> list[str]:
    """Weighted tenant fairness under an arrival storm (cp/admission.py
    deficit round robin): no tenant submitting WITHIN its weight may see
    its p99 admission wait exceed K x the BEST-SERVED in-weight tenant's
    median wait (plus a reconcile-granularity floor — waits quantize to
    the replay's pacing). Tenants the scenario marked as deliberately
    bursting are exempt: they pay for their own flood; the invariant is
    that nobody else does.

    The reference is the best-served tenant's median, not a pooled
    percentile: a starved tenant's own samples dominate any pooled
    statistic, so a pooled bound could never fire — exactly the
    vacuous-invariant trap the canary tests exist to prevent."""
    ctrl = getattr(world.state, "admission", None)
    if ctrl is None:
        return []
    burst = getattr(world, "admission_burst_tenants", set())
    p50s = {t: float(np.percentile(list(ws), 50))
            for t, ws in ctrl.wait_samples.items()
            if t not in burst and len(ws) >= 5}
    if not p50s:
        return []
    best_p50 = min(p50s.values())
    bound = ADMISSION_FAIR_K * max(best_p50, ADMISSION_FAIR_FLOOR_S / 2)
    out: list[str] = []
    for tenant in sorted(p50s):
        p99 = float(np.percentile(list(ctrl.wait_samples[tenant]), 99))
        if p99 > bound:
            out.append(
                f"tenant {tenant} starved: wait p99 {p99:.1f}s > "
                f"{ADMISSION_FAIR_K:g} x best-served median "
                f"{best_p50:.1f}s (bound {bound:.1f}s) while under its "
                f"weight")
    return out


def admission_converged(world, snapshot=None) -> list[str]:
    """Streaming-admission completeness: after settle, every submitted
    request reached a TERMINAL state (placed | departed | parked | shed |
    cancelled) — backpressure may refuse work, parking may defer it, but
    nothing is ever silently lost — and every live streamed service is
    actually IN its stage's settled placement."""
    ctrl = getattr(world.state, "admission", None)
    if ctrl is None or not ctrl.requests:
        return []
    out: list[str] = []
    from ..cp.admission import AdmissionRequest
    for rid in sorted(ctrl.requests):
        r = ctrl.requests[rid]
        if r.state not in AdmissionRequest.TERMINAL:
            out.append(f"request {r.id} ({r.kind} {r.name} for "
                       f"{r.tenant}) still {r.state!r} after settle")
    if snapshot is None:
        snapshot = world.state.placement.snapshot()
    for key in sorted(getattr(ctrl, "_streams", {})):
        view = snapshot.get(key)
        assigned = set(view["assignment"]) if view else set()
        for name in ctrl.live_names(key):
            if name not in assigned:
                out.append(f"admitted service {name} missing from the "
                           f"settled placement of {key}")
        stream = ctrl._streams[key]
        for name in sorted(stream.tombstones):
            if name in assigned:
                out.append(f"departed service {name} still assigned in "
                           f"{key}")
    return out


def admission_quota(world) -> list[str]:
    """Hard tenant quotas (cp/admission.py tenant_caps, tenant-storm
    scenario): after settle, no capped tenant holds more LIVE streamed
    services than its cap, and every quota-parked request belongs to a
    tenant that actually has a cap. Uses the same owner census the
    controller enforces with — a failover that rebuilt the streams must
    still respect the caps it restored from the journal."""
    ctrl = getattr(world.state, "admission", None)
    caps = dict(getattr(world, "tenant_caps", {}) or {})
    if ctrl is None or not caps:
        return []
    out: list[str] = []
    live: dict[str, int] = {}
    for stream in getattr(ctrl, "_streams", {}).values():
        for owner in stream.owner.values():
            live[owner] = live.get(owner, 0) + 1
    for tenant, cap in sorted(caps.items()):
        if live.get(tenant, 0) > int(cap):
            out.append(f"tenant {tenant} holds {live[tenant]} live "
                       f"streamed services over its hard cap {cap}")
    for r in getattr(ctrl, "_parked", ()):
        if getattr(r, "park_reason", None) == "quota" \
                and r.tenant not in caps:
            out.append(f"request {r.id} quota-parked but tenant "
                       f"{r.tenant} has no cap")
    return out


def slo_met(world) -> list[str]:
    """The SLO invariant (SLO invariants beside the safety
    invariants): every objective the world's rolling SLO
    engine (obs/slo.py) declares must hold over the run's LIFETIME
    samples — warm-reschedule latency, admission wait, verdict→converged
    time-to-heal. Converging is necessary; this says it also happened
    fast enough, consistently. Streams the schedule never drove (zero
    samples) are skipped: an objective over an unexercised stream is not
    a miss — the failing-world canaries prove the check has teeth on
    exercised ones."""
    engine = getattr(world.state, "slo", None)
    if engine is None:
        return []
    out: list[str] = []
    for o in engine.objectives:
        n = engine.samples(o.stream)
        if n == 0:
            continue
        observed = engine.observed_quantile(o.stream, o.quantile)
        if observed is not None and observed > o.threshold:
            out.append(
                f"SLO {o.name} missed: observed "
                f"p{o.quantile * 100:g} = {observed:.3f}{o.unit} > "
                f"threshold {o.threshold:g}{o.unit} "
                f"over {n} lifetime samples")
    return out


def record_outage_census(world) -> None:
    """Called by the runner after every fault burst: WHILE a zone outage
    is live, the lost domain's stages may park — but collateral damage to
    a SURVIVING region's stage is a blast-radius breach. The final
    snapshot only sees the healed world, so breaches must be recorded
    mid-outage; `degraded_gracefully` reports them once the run settles.
    Not an invariant itself (returns nothing): it only accumulates
    evidence on `world.outage_breaches`, deduped per detail string."""
    active = getattr(world, "active_outages", None)
    stage_region = getattr(world, "stage_region", {}) or {}
    if not active or not stage_region:
        return
    seen = getattr(world, "_outage_breach_seen", None)
    if seen is None:
        seen = world._outage_breach_seen = set()
    rc = getattr(world.state, "reconverger", None)
    parked = set(rc.parked_stage_keys()) if rc is not None else set()
    snap = world.state.placement.snapshot()
    for key in sorted(stage_region):
        home = stage_region[key]
        if home in active:
            continue               # the lost domain's work MAY park
        view = snap.get(key)
        if key in parked:
            detail = (f"surviving-region stage {key} (home {home}) "
                      f"parked during outage of {sorted(active)}")
        elif view is not None and not view["feasible"]:
            detail = (f"surviving-region stage {key} (home {home}) "
                      f"infeasible during outage of {sorted(active)}")
        else:
            continue
        if detail not in seen:
            seen.add(detail)
            world.outage_breaches.append(detail)


def degraded_gracefully(world) -> list[str]:
    """Zone-outage blast radius (chaos/worldgen.py scenarios): during an
    outage only the lost domain's work parks — every surviving region's
    stage stays feasible (mid-run census via `record_outage_census`) —
    and revival converges: nothing remains parked for a region that came
    back, and no idempotency-keyed redelivery executed twice across the
    kill/revive. Worlds that never lost a zone pass vacuously; the
    fabricated-world canaries prove each clause fires."""
    if not getattr(world, "zone_outages", 0):
        return []
    out = list(getattr(world, "outage_breaches", ()))
    active = getattr(world, "active_outages", set())
    stage_region = getattr(world, "stage_region", {}) or {}
    rc = getattr(world.state, "reconverger", None)
    parked = set(rc.parked_stage_keys()) if rc is not None else set()
    for key in sorted(parked):
        home = stage_region.get(key)
        if home is not None and home not in active:
            out.append(f"stage {key} still parked after its zone "
                       f"{home} revived")
    for _key, (stage, runs) in sorted(
            getattr(world, "idem_executions", {}).items()):
        if runs > 1:
            out.append(f"zone revival doubled execution: a keyed "
                       f"redelivery for {stage} ran {runs} times")
    return out


def metrics_monotonic(world) -> list[str]:
    """Counters never decrease across the run. The metrics registry is the
    operator's ground truth for rates and totals; a counter that went DOWN
    between two check points means a subsystem rebuilt or overwrote its
    series mid-run — exactly the bug a /metrics consumer computing
    rate() cannot see and cannot recover from. The baseline snapshot rides
    on the world object, so the first check of a run establishes it and
    every later check (per fault burst, then final) diffs against the
    last one."""
    from ..obs.metrics import REGISTRY
    snap = REGISTRY.counter_values()
    prev: dict[str, float] = getattr(world, "_metrics_counters_prev", {})
    out = [f"counter {key} decreased: {prev[key]} -> {snap[key]}"
           for key in prev if key in snap and snap[key] < prev[key] - _EPS]
    world._metrics_counters_prev = snap
    return out


def agents_gauge_consistent(world) -> list[str]:
    """The fleet_agents_connected gauge matches the agent registry after
    the run settles (rolling kills + reconnects must net out): a drifting
    gauge means a register/unregister path skipped its metrics update,
    and every dashboard and autoscaling signal built on it lies."""
    from ..obs.metrics import REGISTRY
    gauge = REGISTRY.get("fleet_agents_connected")
    if gauge is None:
        return ["fleet_agents_connected gauge is not registered"]
    shown = gauge.value()
    actual = len(world.state.agent_registry.list_connected())
    if shown != actual:
        return [f"fleet_agents_connected={shown:g} but the registry holds "
                f"{actual} live sessions"]
    return []


INSTANT_INVARIANTS = {
    "capacity-accounting": capacity_accounting,
    "metrics-monotonic": metrics_monotonic,
}
FINAL_INVARIANTS = {
    "capacity-accounting": capacity_accounting,
    "reservations-terminal": reservations_terminal,
    "no-dead-assignments": no_dead_assignments,
    "pools-at-min": pools_at_min,
    "solver-feasible": solver_feasible,
    "containers-converged": containers_converged,
    "selfheal-converged": selfheal_converged,
    "cp-failover-converged": cp_failover_converged,
    "admission-fair": admission_fair,
    "admission-converged": admission_converged,
    "admission-quota": admission_quota,
    "slo-met": slo_met,
    "degraded-gracefully": degraded_gracefully,
    "metrics-monotonic": metrics_monotonic,
    "agents-gauge-consistent": agents_gauge_consistent,
}


def check_instant(world) -> list[str]:
    return [f"[{name}] {v}" for name, fn in INSTANT_INVARIANTS.items()
            for v in fn(world)]


def check_final(world) -> list[str]:
    # one placement snapshot for the whole pass: the two assignment-
    # walking checkers share it instead of each copying every stage's
    # view under the placement lock
    snap = world.state.placement.snapshot()
    out: list[str] = []
    for name, fn in FINAL_INVARIANTS.items():
        found = (fn(world, snapshot=snap)
                 if fn in (no_dead_assignments, containers_converged,
                           selfheal_converged, cp_failover_converged,
                           admission_converged)
                 else fn(world))
        out.extend(f"[{name}] {v}" for v in found)
    return out
