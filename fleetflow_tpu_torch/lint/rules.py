"""The lint rule catalog: static proofs that a deploy is doomed (the
port's copy of ``fleetflow_tpu/lint/rules.py``; its lazy imports resolve
inside the port, and FF013's baseline is the reference's host greedy).

Every rule proves (or strongly suspects — warnings) a deployment failure
WITHOUT running the solver or touching a backend, in the spirit of
compiler-style config validation: a cyclic ``depends_on`` fails lowering,
an unsatisfiable resource ask fails placement, a replica count that can
never spread fails annealing — all minutes into a deploy today, all
decidable at parse time.

Codes are stable (never renumber; retire by leaving a gap):

  FF001  error    dependency cycle among a stage's services
  FF002  error    depends_on references a service missing from the stage
  FF003  error    stage references an unknown service
  FF004  error    stage references an unknown server
  FF005  warning  service redefined in the same file (cross-file merge is
                  the override-file feature; same-file is a paste accident)
  FF006  error    host-port / exclusive-volume pigeonhole: more claimants
                  than nodes (covers affinity-forced single-node conflicts:
                  a one-node stage forces every pair together)
  FF007  error    anti-affinity needs more nodes than the stage declares
  FF008  error    a service's resource ask exceeds every declared server
  FF009  warning  op:// secret reference that cannot resolve on this host
  FF010  warning  colocate_with target absent from the stage (dead pref)
  FF011  warning  container service with neither image nor build{}
  FF012  error    stage aggregate demand exceeds quota / total capacity
  FF013  error    placement prelint: the host-greedy baseline (the same
                  scheduler `fleet up` uses) finds no feasible placement;
                  reported per-service via solver/explain.py breakdowns
  FF014  info     placement bucket waste: the stage's service-row count
                  sits just past a solver bucket boundary, so bucketed
                  solves (solver/buckets.py) pad heavily — advisory only
  FF015  warning  non-streamable service in a `placement { streaming }`
                  stage: ports/volumes/anti-affinity/coloc/deps or
                  replicas>1 can't ride the streaming delta path;
                  deploy.submit sheds it at runtime (cp/admission.py)
  FF016  info     placement plane memory: the stage's estimated
                  per-device solver bytes (packed (S, N) plane math,
                  solver/problem.py) exceed the configured device budget
                  (FLEET_LINT_DEVICE_BUDGET_MB) — surfaced at lint time,
                  before a staging OOM does it the hard way

Rules are pure functions over a :class:`LintContext`; `scope` says what
they iterate ("flow" once, "stage" per stage) and `structural=True` marks
rules whose verdict is independent of node inventory — the subset the
deploy fail-fast path runs (CP inventory is live, not the flow's declared
servers, so inventory-dependent rules stay CLI/CI-side).
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from ..core.model import (Flow, ServerResource, Service, ServiceType,
                          SourceLoc, Stage)
from ..core.secrets import is_op_reference
from .diagnostics import Diagnostic, Severity, SourceMap

__all__ = ["Rule", "RULES", "LintContext", "rule"]


@dataclass
class LintContext:
    flow: Flow
    sourcemap: Optional[SourceMap] = None
    # local=True mirrors lower_stage(local=True): single implicit node,
    # node-targeting constraints dropped (the `fleet up` execution model)
    local: bool = False
    # prelint (FF013) lowers + greedy-solves; deploy fail-fast and huge
    # CI sweeps can turn it off
    prelint: bool = True

    def diag(self, r: "Rule", message: str, loc: Optional[SourceLoc] = None,
             stage: Optional[Stage] = None, hint: str = "",
             severity: Optional[Severity] = None) -> Diagnostic:
        sm = self.sourcemap or SourceMap()
        f, line, col = sm.locate(loc)
        return Diagnostic(code=r.code, severity=severity or r.severity,
                          message=message, file=f, line=line, col=col,
                          rule=r.slug, stage=stage.name if stage else None,
                          hint=hint)

    # ---- shared stage views ------------------------------------------------

    def stage_services(self, stage: Stage) -> list[Service]:
        """Base-merged-with-override services of a stage, SKIPPING names
        that don't resolve (FF003 reports those; downstream rules must not
        crash on them). Unlike Stage.resolved_services this never raises."""
        out = []
        for name in stage.services:
            base = self.flow.services.get(name)
            if base is None:
                continue
            ov = stage.service_overrides.get(name)
            out.append(base.merge(ov) if ov else base)
        return out

    def container_services(self, stage: Stage) -> list[Service]:
        return [s for s in self.stage_services(stage)
                if s.service_type is not ServiceType.STATIC]

    def stage_nodes(self, stage: Stage) -> tuple[list[ServerResource], bool]:
        """(declared node set, is_local) — the same selection lower_stage
        makes: stage.servers > all flow.servers > one implicit local node.
        Unknown declared servers are skipped (FF004 reports them)."""
        if self.local:
            return [], True
        if stage.servers:
            nodes = [self.flow.servers[s] for s in stage.servers
                     if s in self.flow.servers]
            return nodes, False
        if self.flow.servers:
            return list(self.flow.servers.values()), False
        return [], True

    def node_count(self, stage: Stage) -> int:
        nodes, is_local = self.stage_nodes(stage)
        return 1 if is_local else len(nodes)


@dataclass(frozen=True)
class Rule:
    code: str
    slug: str
    severity: Severity
    scope: str                      # "flow" | "stage"
    doc: str
    fn: Callable[..., Iterator[Diagnostic]] = field(compare=False)
    structural: bool = False


RULES: list[Rule] = []


def rule(code: str, slug: str, severity: Severity, scope: str,
         structural: bool = False):
    def register(fn):
        r = Rule(code=code, slug=slug, severity=severity, scope=scope,
                 doc=(fn.__doc__ or "").strip().splitlines()[0],
                 fn=fn, structural=structural)
        RULES.append(r)
        return fn
    return register


def _replicas(svc: Service) -> int:
    return max(svc.replicas, 1)


# --------------------------------------------------------------------------
# structural rules (inventory-independent; the deploy fail-fast subset)
# --------------------------------------------------------------------------

@rule("FF001", "dependency-cycle", Severity.ERROR, "stage", structural=True)
def check_dependency_cycle(r: Rule, ctx: LintContext, stage: Stage):
    """depends_on forms a cycle: no start order exists, lowering rejects it."""
    services = {s.name: s for s in ctx.container_services(stage)}
    color: dict[str, int] = {}          # 0 white / 1 on-stack / 2 done
    parent: dict[str, str] = {}

    def cycle_from(start: str):
        # iterative DFS; return the cycle path when a back edge closes one
        stack = [(start, iter(services[start].depends_on))]
        color[start] = 1
        while stack:
            name, deps = stack[-1]
            for dep in deps:
                if dep not in services:
                    continue                    # FF002's problem
                c = color.get(dep, 0)
                if c == 1:                      # back edge: dep .. name
                    path, cur = [dep], name
                    while cur != dep:
                        path.append(cur)
                        cur = parent[cur]
                    path.append(dep)
                    return path[::-1]
                if c == 0:
                    parent[dep] = name
                    color[dep] = 1
                    stack.append((dep, iter(services[dep].depends_on)))
                    break
            else:
                color[name] = 2
                stack.pop()
        return None

    for name in services:
        if color.get(name, 0) == 0:
            cyc = cycle_from(name)
            if cyc:
                head = services[cyc[0]]
                yield ctx.diag(
                    r, f"dependency cycle: {' -> '.join(cyc)}",
                    loc=head.dep_locs.get(cyc[1]) or head.loc, stage=stage,
                    hint="break the cycle; a start order must exist")
                return      # one cycle per stage is enough signal


@rule("FF002", "unknown-depends-on", Severity.ERROR, "stage", structural=True)
def check_unknown_depends_on(r: Rule, ctx: LintContext, stage: Stage):
    """depends_on names a service the stage does not deploy: the wave
    schedule can never satisfy it (today this dies inside lowering)."""
    in_stage = set(stage.services)
    for svc in ctx.stage_services(stage):
        if svc.service_type is ServiceType.STATIC:
            continue
        for dep in svc.depends_on:
            if dep in in_stage:
                continue
            known = dep in ctx.flow.services
            what = ("defined but not in this stage" if known
                    else "not defined anywhere")
            yield ctx.diag(
                r, f"service {svc.name!r} depends on {dep!r}, "
                   f"which is {what}",
                loc=svc.dep_locs.get(dep) or svc.loc, stage=stage,
                hint=(f"add `service \"{dep}\"` to stage {stage.name!r}"
                      if known else "define the service or fix the name"))


@rule("FF003", "unknown-stage-service", Severity.ERROR, "stage",
      structural=True)
def check_unknown_stage_service(r: Rule, ctx: LintContext, stage: Stage):
    """A stage lists a service that is never defined: resolve fails."""
    for name in stage.services:
        if name not in ctx.flow.services:
            yield ctx.diag(
                r, f"stage {stage.name!r} references unknown service "
                   f"{name!r}",
                loc=stage.service_locs.get(name) or stage.loc, stage=stage,
                hint=f"known services: {sorted(ctx.flow.services)[:8]}")


# --------------------------------------------------------------------------
# inventory rules (need the flow's declared servers)
# --------------------------------------------------------------------------

@rule("FF004", "unknown-server", Severity.ERROR, "stage")
def check_unknown_server(r: Rule, ctx: LintContext, stage: Stage):
    """A stage lists a server that is never declared: lowering rejects it."""
    for name in stage.servers:
        if name not in ctx.flow.servers:
            yield ctx.diag(
                r, f"stage {stage.name!r} references unknown server "
                   f"{name!r}",
                loc=stage.server_locs.get(name) or stage.loc, stage=stage,
                hint=f"declared servers: {sorted(ctx.flow.servers) or '(none)'}")


@rule("FF005", "duplicate-service", Severity.WARNING, "flow")
def check_duplicate_service(r: Rule, ctx: LintContext):
    """Same-file service redefinition: the merge is probably accidental."""
    sm = ctx.sourcemap or SourceMap()
    for name, first, second in ctx.flow.redefinitions:
        f1, l1, _ = sm.locate(first)
        f2, _l2, _c2 = sm.locate(second)
        if f1 != f2:
            continue    # cross-file merge is the override-file feature
        where = f" (first defined at line {l1})" if l1 else ""
        yield ctx.diag(
            r, f"service {name!r} defined twice in the same file{where}; "
               f"later fields merge over earlier ones",
            loc=second,
            hint="if the merge is intentional, split the override into its "
                 "own file; otherwise rename one of the two")


@rule("FF006", "port-volume-pigeonhole", Severity.ERROR, "stage")
def check_port_volume_pigeonhole(r: Rule, ctx: LintContext, stage: Stage):
    """More claimants of an exclusive host resource (host port, writable
    host path) than nodes: each claimant needs its own node, so placement
    is infeasible by pigeonhole — including the affinity-forced case where
    a single-node stage forces every pair onto one host."""
    n_nodes = ctx.node_count(stage)
    ports: dict[tuple, list[tuple[Service, int, Optional[SourceLoc]]]] = {}
    vols: dict[str, list[tuple[Service, int, Optional[SourceLoc]]]] = {}
    for svc in ctx.container_services(stage):
        reps = _replicas(svc)
        for p in {p.key(): p for p in svc.ports}.values():
            ports.setdefault(p.key(), []).append((svc, reps, p.loc or svc.loc))
        seen_keys = set()
        for v in svc.volumes:
            ck = v.conflict_key()
            if ck is not None and ck not in seen_keys:
                seen_keys.add(ck)
                vols.setdefault(ck, []).append((svc, reps, v.loc or svc.loc))

    for key, members in sorted(ports.items(), key=lambda kv: kv[0]):
        total = sum(reps for _, reps, _ in members)
        if total > n_nodes:
            ip, port, proto = key
            names = ", ".join(f"{s.name}x{reps}" if reps > 1 else s.name
                              for s, reps, _ in members)
            yield ctx.diag(
                r, f"host port {port}/{proto} is published by {total} "
                   f"service row(s) ({names}) but the stage has only "
                   f"{n_nodes} node(s); a host port fits one row per node",
                loc=members[-1][2], stage=stage,
                hint="drop replicas, remap ports, or add servers")
    for ck, members in sorted(vols.items()):
        total = sum(reps for _, reps, _ in members)
        if total > n_nodes:
            names = ", ".join(f"{s.name}x{reps}" if reps > 1 else s.name
                              for s, reps, _ in members)
            yield ctx.diag(
                r, f"writable host path {ck!r} is mounted by {total} "
                   f"service row(s) ({names}) but the stage has only "
                   f"{n_nodes} node(s); exclusive writers need a node each",
                loc=members[-1][2], stage=stage,
                hint="mark read-only mounts read-only=true or add servers")


@rule("FF007", "anti-affinity-overflow", Severity.ERROR, "stage")
def check_anti_affinity_overflow(r: Rule, ctx: LintContext, stage: Stage):
    """An anti-affinity group needs more nodes than the stage declares."""
    if ctx.local:
        return   # lower_stage(local=True) drops anti-affinity entirely
    n_nodes = ctx.node_count(stage)
    services = ctx.container_services(stage)
    names = {s.name for s in services}
    label_members: dict[str, list[tuple[Service, int]]] = {}
    for svc in services:
        reps = _replicas(svc)
        for key in dict.fromkeys(svc.anti_affinity):
            if key == svc.name:
                # self-anti: hard replica spreading — R replicas, R nodes
                if reps > n_nodes:
                    yield ctx.diag(
                        r, f"service {svc.name!r} spreads {reps} replicas "
                           f"via anti_affinity but the stage has only "
                           f"{n_nodes} node(s)",
                        loc=svc.loc, stage=stage,
                        hint="lower replicas or add servers")
            elif key in names:
                # target-style pair: declarer and target need 2 nodes
                if n_nodes < 2:
                    yield ctx.diag(
                        r, f"service {svc.name!r} declares anti_affinity "
                           f"with {key!r} but the stage has only "
                           f"{n_nodes} node(s) to separate them across",
                        loc=svc.loc, stage=stage)
            else:
                label_members.setdefault(key, []).append((svc, reps))
    for label, members in sorted(label_members.items()):
        total = sum(reps for _, reps in members)
        if total > n_nodes:
            who = ", ".join(s.name for s, _ in members)
            yield ctx.diag(
                r, f"anti-affinity group {label!r} has {total} mutually "
                   f"exclusive row(s) ({who}) but the stage has only "
                   f"{n_nodes} node(s)",
                loc=members[0][0].loc, stage=stage)


@rule("FF008", "oversized-resources", Severity.ERROR, "stage")
def check_oversized_resources(r: Rule, ctx: LintContext, stage: Stage):
    """A service's resource ask fits NO declared server, even empty."""
    nodes, is_local = ctx.stage_nodes(stage)
    if is_local or not nodes:
        return   # the implicit local node has effectively infinite capacity
    for svc in ctx.container_services(stage):
        d = svc.resources
        if any(n.capacity.cpu >= d.cpu and n.capacity.memory >= d.memory
               and n.capacity.disk >= d.disk for n in nodes):
            continue
        biggest = max(nodes, key=lambda n: (n.capacity.cpu,
                                            n.capacity.memory))
        yield ctx.diag(
            r, f"service {svc.name!r} asks cpu={d.cpu:g} "
               f"memory={d.memory:g}MiB disk={d.disk:g}MiB but no declared "
               f"server fits it (largest: {biggest.name!r} cpu="
               f"{biggest.capacity.cpu:g} memory={biggest.capacity.memory:g}"
               f"MiB disk={biggest.capacity.disk:g}MiB)",
            loc=svc.loc, stage=stage,
            hint="shrink the request or declare a bigger server")


@rule("FF009", "unresolvable-secret", Severity.WARNING, "flow")
def check_unresolvable_secret(r: Rule, ctx: LintContext):
    """An op:// secret reference that cannot resolve on this machine."""
    if shutil.which("op"):
        return
    refs = sorted(k for k, v in ctx.flow.variables.items()
                  if isinstance(v, str) and is_op_reference(v))
    for key in refs:
        yield ctx.diag(
            r, f"variable {key!r} references a 1Password secret "
               f"({ctx.flow.variables[key]}) but the `op` CLI is not "
               f"installed here; deploys from this machine will fail at "
               f"template render",
            loc=ctx.flow.variable_locs.get(key),
            hint="install the 1Password CLI or override the variable")


@rule("FF010", "unknown-colocate", Severity.WARNING, "stage")
def check_unknown_colocate(r: Rule, ctx: LintContext, stage: Stage):
    """colocate_with names a service outside the stage: dead preference."""
    names = {s.name for s in ctx.container_services(stage)}
    for svc in ctx.container_services(stage):
        for target in dict.fromkeys(svc.colocate_with):
            if target not in names:
                yield ctx.diag(
                    r, f"service {svc.name!r} colocates with {target!r}, "
                       f"which is not a container service of this stage; "
                       f"the preference scores nothing",
                    loc=svc.loc, stage=stage)


@rule("FF011", "missing-image", Severity.WARNING, "stage")
def check_missing_image(r: Rule, ctx: LintContext, stage: Stage):
    """Container service with neither image nor build{}: the engine will
    try to pull '<name>:latest', which is almost never what was meant."""
    for svc in ctx.container_services(stage):
        if svc.image is None and svc.build is None:
            yield ctx.diag(
                r, f"service {svc.name!r} has neither image nor build{{}}; "
                   f"the deploy will attempt to pull "
                   f"{svc.image_name()!r}",
                loc=svc.loc, stage=stage,
                hint="add `image \"...\"` or a build{} block")


@rule("FF012", "quota-exceeded", Severity.ERROR, "stage")
def check_quota_exceeded(r: Rule, ctx: LintContext, stage: Stage):
    """Stage aggregate demand exceeds its quota or total declared capacity."""
    services = ctx.container_services(stage)
    rows = sum(_replicas(s) for s in services)
    totals = [0.0, 0.0, 0.0]
    for s in services:
        reps = _replicas(s)
        for i, v in enumerate(s.resources.as_tuple()):
            totals[i] += v * reps
    axes = ("cpu", "memory", "disk")

    q = stage.placement.resource_quota if stage.placement else None
    if q is not None:
        if q.max_services is not None and rows > q.max_services:
            yield ctx.diag(
                r, f"stage {stage.name!r} has {rows} service rows > "
                   f"quota max-services {q.max_services}",
                loc=stage.loc, stage=stage)
        for i, cap in enumerate((q.cpu, q.memory, q.disk)):
            if cap is not None and totals[i] > cap * (1 + 1e-6) + 1e-9:
                yield ctx.diag(
                    r, f"stage {stage.name!r} total {axes[i]} demand "
                       f"{totals[i]:g} exceeds quota {cap:g}",
                    loc=stage.loc, stage=stage)

    nodes, is_local = ctx.stage_nodes(stage)
    if not is_local and nodes:
        caps = [sum(n.capacity.as_tuple()[i] for n in nodes)
                for i in range(3)]
        for i in range(3):
            if totals[i] > caps[i] * (1 + 1e-6) + 1e-9:
                yield ctx.diag(
                    r, f"stage {stage.name!r} total {axes[i]} demand "
                       f"{totals[i]:g} exceeds the {len(nodes)} declared "
                       f"server(s)' combined capacity {caps[i]:g}",
                    loc=stage.loc, stage=stage,
                    hint="add servers or shrink resource requests")


@rule("FF013", "placement-prelint", Severity.ERROR, "stage")
def check_placement_prelint(r: Rule, ctx: LintContext, stage: Stage):
    """Lower the stage for real and run the host-greedy baseline (the same
    scheduler `fleet up` defaults to); if it finds no feasible placement,
    report the blocked services with solver/explain.py's per-constraint
    breakdown — eligibility, capacity, conflict occupancy — so the operator
    sees WHY, not just that it failed."""
    if not ctx.prelint:
        return
    import numpy as np

    from ..core.errors import SolverError
    from ..lower.tensors import lower_stage
    from ..sched import HostGreedyScheduler, place_with_fallback
    from ..solver.explain import explain_assignment

    container = ctx.container_services(stage)
    if not container:
        return   # static-only or empty: nothing to place
    import logging
    lower_log = logging.getLogger("fleetflow.lower")
    prev_level = lower_log.level
    lower_log.setLevel(logging.ERROR)   # lint rules (FF010) own these
    try:                                # warnings; don't double-report
        pt = lower_stage(ctx.flow, stage.name, local=ctx.local)
    except SolverError as e:
        yield ctx.diag(r, f"lowering failed: {e}", loc=stage.loc,
                       stage=stage)
        return
    except Exception as e:       # KeyError from resolve etc. — FF003 turf
        yield ctx.diag(r, f"stage cannot be lowered: {e}", loc=stage.loc,
                       stage=stage)
        return
    finally:
        lower_log.setLevel(prev_level)
    placement, relaxed = place_with_fallback(HostGreedyScheduler(), pt)
    if placement.feasible:
        return
    msg = (f"no feasible placement for {pt.S} service row(s) on {pt.N} "
           f"node(s): {placement.violations} violation(s) under the "
           f"host-greedy baseline")
    if relaxed:
        msg += f" (even after relaxing {', '.join(relaxed)})"
    details = []
    if placement.raw is not None:
        asn = np.asarray(placement.raw)
        for i in range(pt.S):
            if len(details) >= 3:
                break
            try:
                ex = explain_assignment(pt, asn, pt.service_names[i])
            except Exception:
                continue
            if ex["chosen"]["feasible"]:
                continue
            bc = ex["blocked_counts"]
            details.append(
                f"{pt.service_names[i]}: {bc['feasible']}/{bc['total_nodes']}"
                f" nodes feasible (ineligible {bc['ineligible']}, "
                f"capacity-blocked {bc['capacity']}, conflict-blocked "
                f"{bc['conflicts']})")
    if details:
        msg += "; " + "; ".join(details)
    yield ctx.diag(r, msg, loc=stage.loc, stage=stage,
                   hint="`fleet cp placement explain` breaks down any "
                        "single service in full")


@rule("FF015", "non-streamable-service", Severity.WARNING, "stage",
      structural=True)
def check_non_streamable(r: Rule, ctx: LintContext, stage: Stage):
    """A stage declared `placement { streaming #true }` (aimed at the
    deploy.submit continuous-arrival path) carries services the streaming
    delta path must reject at runtime: ports, volumes, anti-affinity,
    colocation, dependencies, or replicas > 1 all bring hard-constraint
    ids or multi-row shapes the resident delta kernel cannot express
    (solver/resident._arrivals_compatible), so cp/admission.py sheds them
    with AdmissionRejected mid-stream — this is the pre-deploy signal."""
    if stage.placement is None or not stage.placement.streaming:
        return
    # the SAME predicate the CP applies at submit time (cp/admission.py)
    # — lint must never drift from what the runtime actually rejects
    from ..cp.admission import _simple_reject

    for svc in ctx.container_services(stage):
        why = _simple_reject(svc)
        if why is None:
            continue
        yield ctx.diag(
            r, f"service {svc.name!r} cannot ride the streaming delta "
               f"path ({why}); deploy.submit will reject it at runtime "
               f"(AdmissionRejected)",
            loc=svc.loc, stage=stage,
            hint="route constrained services through deploy.execute, or "
                 "drop the constraint "
                 "(docs/guide/14-streaming-admission.md)")


@rule("FF014", "placement-bucket-waste", Severity.INFO, "stage")
def check_bucket_waste(r: Rule, ctx: LintContext, stage: Stage):
    """The stage's expanded row count sits just past a solver bucket
    boundary: bucketed solves (solver/buckets.py, the warm reschedule
    path) will pad it up to the next tier, annealing that many phantom
    rows on every re-solve. Advisory (INFO): correctness is untouched —
    this reports the standing pad-waste and the boundary it straddles so
    an operator a few replicas past a tier can decide knowingly."""
    if ctx.local:
        return          # local execution never hits the bucketed solver
    from ..solver.buckets import bucket_config, bucket_bounds

    cfg = bucket_config()
    if not cfg.enabled:
        return
    rows = sum(_replicas(s) for s in ctx.container_services(stage))
    if rows < cfg.minimum:
        return          # below the first tier, padding is noise-level
    lower, upper = bucket_bounds(rows, growth=cfg.growth,
                                 minimum=cfg.minimum, align=cfg.align)
    waste = 1.0 - rows / upper
    if waste < 0.15:
        return
    yield ctx.diag(
        r, f"stage {stage.name!r} lowers to {rows} service row(s), just "
           f"past the {lower}-row solver bucket: bucketed solves pad to "
           f"{upper} rows ({waste:.0%} phantom pad-waste per re-solve)",
        loc=stage.loc, stage=stage,
        hint=f"dropping {rows - lower} row(s) would fit the {lower} "
             f"bucket; or tune FLEET_BUCKET_GROWTH/FLEET_BUCKET_MIN "
             f"(docs/guide/11-performance.md)")


def _plane_budget_bytes() -> int:
    """FLEET_LINT_DEVICE_BUDGET_MB: the per-device byte budget FF016
    estimates stages against. The default, 16384, is the reference's, so
    both packages report the same diagnostics on the same flow."""
    import os
    try:
        mb = float(os.environ.get("FLEET_LINT_DEVICE_BUDGET_MB", "")
                   or 16384)
    except ValueError:
        mb = 16384.0
    return int(mb * 1e6)


@rule("FF016", "placement-plane-memory", Severity.INFO, "stage")
def check_plane_memory(r: Rule, ctx: LintContext, stage: Stage):
    """The stage's estimated per-device solver bytes exceed the device
    budget: the same packed-plane math the staged problem actually uses
    (solver/problem.py — bit-packed (S, ceil(N/32)) uint32 eligibility,
    a preference plane only when the stage scores nodes), evaluated at
    the bucket tier the rows pad to, plus the node capacity/load planes.
    The anneal's (N, G)/(N, Gc) occupancy tables are NOT estimated —
    G/Gc depend on lowered content (port/volume/anti/coloc groups), so
    the estimate is a floor, not a ceiling. Advisory (INFO, never
    gates): an operator sees the memory shape of a stage at lint time
    instead of at a staging OOM."""
    if ctx.local:
        return          # local execution never stages on a device
    nodes, is_local = ctx.stage_nodes(stage)
    if is_local:
        return
    services = ctx.container_services(stage)
    rows = sum(_replicas(s) for s in services)
    if rows == 0:
        return
    from ..core.model import ResourceSpec
    from ..solver.buckets import bucket_config, bucket_size
    from ..solver.problem import packed_width

    cfg = bucket_config()
    S_pad = (bucket_size(rows, growth=cfg.growth, minimum=cfg.minimum,
                         align=cfg.align) if cfg.enabled else rows)
    N = len(nodes)
    R = len(ResourceSpec.axes())
    # the packed (S, N) planes + per-row tables the staging materializes
    elig = S_pad * packed_width(N) * 4          # bit-packed uint32 words
    has_pref = bool(stage.placement and stage.placement.preferred_labels)
    pref = S_pad * N * 4 if has_pref else 0     # absent plane costs zero
    demand = S_pad * R * 4
    node_planes = N * R * 4 * 2                 # capacity + carried load
    est = elig + pref + demand + node_planes
    budget = _plane_budget_bytes()
    if est <= budget:
        return
    parts = [f"eligible {elig / 1e6:.1f} MB (packed)"]
    if has_pref:
        parts.append(f"preferred {pref / 1e6:.1f} MB")
    parts.append(f"demand {demand / 1e6:.1f} MB")
    yield ctx.diag(
        r, f"stage {stage.name!r} stages ~{est / 1e6:.1f} MB of solver "
           f"planes per device ({rows} row(s) padded to {S_pad} x {N} "
           f"node(s): {', '.join(parts)}), over the "
           f"{budget / 1e6:.0f} MB device budget",
        loc=stage.loc, stage=stage,
        hint="shard the stage over a device mesh (FLEET_SHARDED=1 — the "
             "packed (S, ·) planes divide by mesh width), or raise "
             "FLEET_LINT_DEVICE_BUDGET_MB if the device is larger "
             "(docs/guide/11-performance.md)")
