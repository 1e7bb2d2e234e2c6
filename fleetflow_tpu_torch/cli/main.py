"""The `fleet` command tree.

Analog of fleetflow main.rs:33-296 (clap Commands/CpCommands) + commands/*:
Daily `up/down/restart/ps/logs/exec`, Ship `build/deploy`, Admin `cp`
subgroups (login/logout/daemon/tenant/project/server/cost/dns/registry/
volume/build/stage), Util `validate/solve/init/mcp`. Stage comes from the
positional arg, `-s`, or FLEET_STAGE (main.rs:40-47). When no config is
found, `fleet init` writes a starter (the reference launches its ratatui
wizard, tui/init.rs:123).

The verbs that place (`solve`, `chaos run`, `plan simulate`, `mcp`'s
`fleet_solve`, `cp registry solve`) run on the card: the top-level
`--device` names the card solver's device (default: the card; `cpu` runs
its plain PyTorch versions), and a missing card is an error (exit 1),
never a quiet placement on the host. `--host` asks for the host placer.
The `audit` verbs (kernels, hygiene, dataflow, all) analyse the port's
own code: `audit kernels` and `audit all` run the hot dispatches on the
same `--device` (`fleet --device cpu audit all` runs them on the plain
versions, and without a card the default is an error, exit 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from ..core.errors import (CloudError, ConfigNotFound, ControlPlaneError,
                           FlowError, SolverError)
from ..core.loader import load_project
from ..core.model import Backend, Flow, Stage
from ..lower.tensors import lower_stage
from ..runtime.backend import DockerCliBackend, MockBackend
from ..runtime.engine import DeployEngine, DeployRequest
from ..sched import pick_scheduler, place_with_fallback
from .client import CpClient, CredentialStore, default_endpoint
from ..cp.protocol import RpcError
from .utils import determine_stage_name, filter_services, mask_env

__all__ = ["main", "build_parser"]


# --------------------------------------------------------------------------
# plumbing
# --------------------------------------------------------------------------

def _load(args) -> Flow:
    try:
        return load_project(stage=_stage(args),
                            start=getattr(args, "project_root", None))
    except ConfigNotFound:
        print("no fleet config found (.fleetflow/fleet.kdl). "
              "run `fleet init` to create one.", file=sys.stderr)
        raise SystemExit(2) from None


def _stage(args) -> str:
    return determine_stage_name(getattr(args, "stage", None),
                                getattr(args, "stage_flag", None))


def _backend(args):
    import os
    if os.environ.get("FLEET_BACKEND") == "mock" or getattr(args, "mock", False):
        b = MockBackend(auto_pull=True)
        return b
    b = DockerCliBackend()
    if not b.ping():
        print("docker daemon unreachable. start docker, or set "
              "FLEET_BACKEND=mock for a dry environment.", file=sys.stderr)
        raise SystemExit(3)
    return b


def _print_plan(flow: Flow, stage_name: str,
                services: list[str]) -> None:
    """Dry-run plan printer with secret masking (up.rs:57-136)."""
    stage = flow.stage(stage_name)
    print(f"plan: project {flow.name!r} stage {stage_name!r} "
          f"backend {stage.backend.value}")
    for svc in stage.resolved_services(flow):
        if services and svc.name not in services:
            continue
        print(f"  service {svc.name}  image {svc.image_name()}")
        for p in svc.ports:
            print(f"    port {p.host} -> {p.container}/{p.protocol.value}")
        for v in svc.volumes:
            ro = " (ro)" if v.read_only else ""
            print(f"    volume {v.host} -> {v.container}{ro}")
        for k, v in sorted(mask_env(svc.environment).items()):
            print(f"    env {k}={v}")
        if svc.depends_on:
            print(f"    depends_on {', '.join(svc.depends_on)}")


def _observed_for(cp, flow: Flow, stage, stage_name: str,
                  services: list[str]) -> list[dict]:
    """Observed containers of this flow's stage, scoped to the stage's
    DECLARED servers: label attribution alone (project/stage/service)
    could match another tenant's same-named project on a shared CP, and
    acting on those would be a cross-tenant action."""
    rows = cp.request("container", "ps", {})["containers"]
    return [r for r in rows
            if r.get("project") == flow.name
            and r.get("stage") == stage_name
            and (not services or r.get("service") in services)
            and r.get("server") in stage.servers]


def _event_printer(event) -> None:
    print(f"  {event}")


def _split_stage(flow: Flow, stage, services: list[str]):
    """(static, container) resolved services of a stage, honoring the -n
    service filter."""
    from ..runtime.static_site import split_static_services
    resolved = [s for s in stage.resolved_services(flow)
                if not services or s.name in services]
    return split_static_services(resolved)


def _wait_procs(dev_procs) -> int:
    """Foreground-wait on static dev servers (up.rs:190-194)."""
    for name, proc in dev_procs:
        print(f"  {name}: dev server PID {proc.pid} (Ctrl+C to stop)")
    for _, proc in dev_procs:
        proc.wait()
    return 0


def _stop_procs(dev_procs) -> None:
    """Tear down dev servers when the rest of the up failed."""
    for _, proc in dev_procs:
        try:
            proc.terminate()
        except OSError:
            pass


# --------------------------------------------------------------------------
# Daily commands
# --------------------------------------------------------------------------

def cmd_up(args) -> int:
    flow = _load(args)
    stage_name = _stage(args)
    stage = flow.stage(stage_name)
    services = filter_services(stage.services, args.services or [])
    if args.dry_run:
        _print_plan(flow, stage_name, services)
        return 0
    # static services: build + wrangler pages dev, before the container
    # loop (up.rs:139-195); each dev server gets its own port
    from ..runtime.static_site import up_static
    static, container = _split_stage(flow, stage, services)
    dev_procs = []
    for i, svc in enumerate(static):
        print(f"▶ {svc.name} — static site dev server")
        try:
            proc = up_static(svc, getattr(args, "project_root", None) or ".",
                             on_line=lambda line: print(f"  {line}"),
                             port=8788 + i)
        except (FlowError, CloudError) as e:
            print(f"  {svc.name}: {e}", file=sys.stderr)
            _stop_procs(dev_procs)
            return 1
        if proc is not None:
            dev_procs.append((svc.name, proc))
    if static and not container:
        # nothing but static services: wait in the foreground like the
        # reference (Ctrl+C stops the dev servers)
        return _wait_procs(dev_procs)
    if stage.backend in (Backend.QUADLET, Backend.COMPOSE) and (
            args.services or args.no_pull):
        print("warning: -n/--no-pull are not supported on the "
              f"{stage.backend.value} backend; applying the whole stage",
              file=sys.stderr)
    if stage.backend is Backend.QUADLET:
        from ..runtime.quadlet import apply_stage
        outcome = apply_stage(flow, stage_name)
        for u in outcome.started:
            print(f"  started {u}")
        for u, err in outcome.errors.items():
            print(f"  FAILED {u}: {err}", file=sys.stderr)
        rc = 0 if outcome.ok else 1
        if rc != 0:
            _stop_procs(dev_procs)
            return rc
        return _wait_procs(dev_procs)
    if stage.backend is Backend.COMPOSE:
        from ..runtime.compose import compose_up
        rc, out = compose_up(flow, stage_name,
                             getattr(args, "project_root", None) or ".")
        print(out)
        if rc != 0:
            _stop_procs(dev_procs)
            return rc
        return _wait_procs(dev_procs)
    target = args.services or []
    if static:
        # static services never reach the container engine
        target = [s.name for s in container]
    backend = _backend(args)
    # local builds before the container loop (up.rs:6-51): a service with
    # build{} gets its image built here so create/start never pulls a tag
    # that only exists locally. Built under the SAME tag the engine will
    # create from (svc.image_name()) — the resolver's registry-prefixed
    # tag is the push workflow's, not the local engine's. Mock backend
    # materializes images on pull, so builds are skipped there.
    if not isinstance(backend, MockBackend):
        buildable = [s for s in container
                     if s.build is not None and
                     (not target or s.name in target)]
        try:
            _build_images(flow, buildable,
                          getattr(args, "project_root", None),
                          tag_for=lambda s: s.image_name(), stage=stage)
        except FlowError as e:
            print(f"  {e}", file=sys.stderr)
            _stop_procs(dev_procs)
            return 1
    engine = DeployEngine(backend, scheduler=pick_scheduler(
        len(services), 1, prefer_gpu=False))
    res = engine.execute(
        DeployRequest(flow=flow, stage_name=stage_name,
                      target_services=target,
                      no_pull=args.no_pull),
        on_event=_event_printer)
    if not res.ok:
        _stop_procs(dev_procs)
        return 1
    # one-shot readiness report (up.rs:444-505): failures are reported,
    # not fatal — the containers are up, the endpoint just isn't answering
    from ..runtime.readiness import run_readiness_checks
    wanted = set(target or stage.services)
    run_readiness_checks(
        [s for s in stage.resolved_services(flow) if s.name in wanted],
        on_line=print)
    # keep the dev servers in the foreground alongside the containers
    return _wait_procs(dev_procs)


def cmd_down(args) -> int:
    flow = _load(args)
    stage_name = _stage(args)
    stage = flow.stage(stage_name)
    if stage.servers and not getattr(args, "local", False):
        # remote path, same gate as `fleet deploy` (a servers-stage is
        # CP-routed — asymmetric gates would let a CP-deployed stage
        # silently "tear down" locally, removing nothing): every
        # connected stage agent runs the backend-appropriate down for
        # its node and the CP returns the committed capacity
        # (deploy.execute's complement; the reference's down is
        # local-only, commands/down.rs). `fleet up` is always local even
        # on a servers-stage, so --local forces the local path for
        # cleaning those up.
        req = DeployRequest(flow=flow, stage_name=stage_name,
                            target_services=args.services or [])
        with CpClient(args.cp) as cp:
            out = cp.request("deploy", "down",
                             {"request": req.to_dict(),
                              "remove": getattr(args, "remove", False),
                              # same tenant resolution as cmd_deploy, so
                              # the teardown lands on the REAL stage record
                              "tenant": getattr(args, "tenant", None) or
                              (flow.tenant.name if flow.tenant
                               else "default")},
                             timeout=600)
        for slug, info in sorted(out["nodes"].items()):
            if isinstance(info, dict):
                if info.get("note"):
                    print(f"  {slug}: {info['note']}")
                else:
                    removed = info.get("removed") or []
                    print(f"  {slug}: removed {len(removed)} "
                          f"({info.get('backend', 'docker')})")
            else:
                print(f"  {slug}: FAILED — {info}", file=sys.stderr)
        return 0 if out["ok"] else 1
    if stage.backend is Backend.QUADLET:
        # commands/quadlet.rs down:71 — systemctl stop (+ unit removal),
        # never the docker engine
        if args.services:
            print("warning: -n is not supported on the quadlet backend; "
                  "stopping the whole stage", file=sys.stderr)
        from ..runtime.quadlet import down_stage
        outcome = down_stage(flow, stage_name,
                             remove=getattr(args, "remove", False))
        for u in outcome.stopped:
            print(f"  stopped {u}")
        for u in outcome.removed:
            print(f"  removed {u}")
        for u, err in outcome.errors.items():
            print(f"  FAILED {u}: {err}", file=sys.stderr)
        return 0 if outcome.ok else 1
    if getattr(args, "remove", False):
        print("warning: --remove only applies to the quadlet backend; "
              "ignored", file=sys.stderr)
    if stage.backend is Backend.COMPOSE:
        if args.services:
            print("warning: -n is not supported on the compose backend; "
                  "taking the whole stage down", file=sys.stderr)
        from ..runtime.compose import compose_down
        rc, out = compose_down(flow, stage_name,
                               getattr(args, "project_root", None) or ".")
        print(out)
        return rc
    engine = DeployEngine(_backend(args))
    res = engine.down(flow, stage_name, args.services or None,
                      on_event=_event_printer)
    print(f"removed {len(res.removed)} containers")
    return 0


def cmd_restart(args) -> int:
    flow = _load(args)
    stage_name = _stage(args)
    stage = flow.stage(stage_name)
    names = filter_services(stage.services, args.services or [])
    if stage.servers and not getattr(args, "local", False):
        # remote path (same gate as deploy/down/logs): restart each
        # service's observed containers on their owning nodes
        failed = 0
        with CpClient(args.cp) as cp:
            mine = _observed_for(cp, flow, stage, stage_name, names)
            if not mine:
                print(f"no observed containers for "
                      f"{flow.name}/{stage_name} services {names} "
                      f"(agents report inventory on their monitor "
                      f"interval)", file=sys.stderr)
                return 1
            for r in sorted(mine, key=lambda r: r.get("name", "")):
                try:
                    cp.request("container", "restart",
                               {"server": r["server"],
                                "container": r["name"]})
                    print(f"  restarted {r['name']} on {r['server']}")
                except RpcError as e:
                    print(f"  {r['name']} on {r['server']}: FAILED — {e}",
                          file=sys.stderr)
                    failed += 1
        return 1 if failed else 0
    backend = _backend(args)
    from ..runtime.converter import container_name
    for svc in names:
        cname = container_name(flow.name, stage_name, svc)
        try:
            backend.restart(cname)
            print(f"  restarted {cname}")
        except FlowError as e:
            print(f"  {cname}: {e}", file=sys.stderr)
    return 0


def cmd_ps(args) -> int:
    if args.global_ or args.project:
        with CpClient(args.cp) as cp:
            payload = {}
            out = cp.request("container", "ps", payload)
            rows = out["containers"]
            if args.project:
                rows = [r for r in rows if r.get("project") == args.project]
            _print_ps_rows(rows)
        return 0
    flow = _load(args)
    stage_name = _stage(args)
    backend = _backend(args)
    infos = backend.list(label_filter={"fleetflow.project": flow.name,
                                       "fleetflow.stage": stage_name})
    rows = [{"name": i.name, "state": i.state, "health": i.health,
             "image": i.image, "service": i.labels.get("fleetflow.service")}
            for i in infos]
    _print_ps_rows(rows)
    return 0


def _print_ps_rows(rows: list[dict]) -> None:
    if not rows:
        print("(no containers)")
        return
    w = max(len(r.get("name", "")) for r in rows) + 2
    print(f"{'NAME':<{w}}{'STATE':<12}{'HEALTH':<12}IMAGE")
    for r in rows:
        print(f"{r.get('name', ''):<{w}}{r.get('state', ''):<12}"
              f"{r.get('health') or '-':<12}{r.get('image', '')}")


def cmd_logs(args) -> int:
    flow = _load(args)
    stage_name = _stage(args)
    from ..runtime.converter import container_name
    stage = flow.stage(stage_name)
    if stage.servers and not getattr(args, "local", False):
        # remote path (same gate as deploy/down): find where the CP
        # observed the service's containers, fetch live logs from each
        # owning node's agent
        if getattr(args, "follow", False):
            print("warning: --follow is not supported on the CP-routed "
                  "path; printing a one-shot tail", file=sys.stderr)
        failed = 0
        with CpClient(args.cp) as cp:
            mine = _observed_for(cp, flow, stage, stage_name,
                                 [args.service])
            if not mine:
                print(f"no observed containers for "
                      f"{flow.name}/{stage_name}/{args.service} "
                      f"(agents report inventory on their monitor "
                      f"interval)", file=sys.stderr)
                return 1
            for r in sorted(mine, key=lambda r: r.get("name", "")):
                prefix = (f"[{r['server']}/{r['name']}] "
                          if len(mine) > 1 else "")
                try:
                    out = cp.request("container", "logs.live",
                                     {"server": r["server"],
                                      "container": r["name"],
                                      "tail": args.tail,
                                      "since": args.since})
                except RpcError as e:
                    # per-node failures must not hide the other replicas'
                    # logs (same per-node reporting as cmd_down)
                    print(f"{prefix or r['server'] + ': '}FAILED — {e}",
                          file=sys.stderr)
                    failed += 1
                    continue
                for line in out.get("logs", "").splitlines():
                    print(f"{prefix}{line}")
        return 1 if failed else 0
    backend = _backend(args)
    cname = container_name(flow.name, stage_name, args.service)
    if getattr(args, "follow", False):
        # logs.rs follow path; mock backend has no stream to follow
        if not hasattr(backend, "logs_follow"):
            print(backend.logs(cname, tail=args.tail, since=args.since),
                  end="")
            return 0
        return backend.logs_follow(cname, tail=args.tail, since=args.since)
    print(backend.logs(cname, tail=args.tail, since=args.since), end="")
    return 0


def cmd_exec(args) -> int:
    flow = _load(args)
    stage_name = _stage(args)
    from ..runtime.converter import container_name
    import subprocess
    if args.service not in flow.services:
        print(f"service {args.service!r} not found. available: "
              f"{', '.join(sorted(flow.services))}", file=sys.stderr)
        return 1
    cname = container_name(flow.name, stage_name, args.service)
    cmd = args.cmd or ["/bin/sh"]
    # shells auto-enable interactive+tty (exec.rs:40-43); explicit -i/-t
    # add them for anything else, gated on an actual terminal
    is_shell = len(cmd) == 1 and cmd[0] in ("/bin/sh", "/bin/bash",
                                            "sh", "bash")
    interactive = args.interactive or is_shell
    tty = (args.tty or is_shell) and sys.stdin.isatty()
    argv = ["docker", "exec"]
    if interactive:
        argv.append("-i")
    if tty:
        argv.append("-t")
    argv.append(cname)
    argv += cmd
    return subprocess.call(argv)


# --------------------------------------------------------------------------
# Ship commands
# --------------------------------------------------------------------------

def _build_images(flow: Flow, services, project_root: Optional[str],
                  registry: Optional[str] = None, push: bool = False,
                  tag_for=None, stage: Optional[Stage] = None) -> list[str]:
    """Shared build loop (build.rs orchestrator) used by `fleet build` and
    the pre-deploy build step of `fleet up`. `tag_for(svc)` overrides the
    resolver's (registry-prefixed) tag — the local engine creates from
    svc.image_name(), the push workflow from the resolver tag. `stage`
    (when the caller has one, e.g. `fleet up`) slots Stage.registry into
    the precedence chain. Returns the built tags; raises
    BuildError/BuildFailed (FlowError) on failure."""
    import dataclasses as _dc

    from ..build import BuildResolver, ImageBuilder, ImagePusher
    flow_registry = flow.registry.url if flow.registry else None
    stage_registry = stage.registry if stage is not None else None
    resolver = BuildResolver(project_root or ".",
                             registry=registry or stage_registry
                             or flow_registry)
    tags = []
    for svc in services:
        res = resolver
        if registry is None and svc.registry:
            # reference precedence: CLI flag > service.registry > stage >
            # flow (build.rs:203-205); the stage/flow fallback is baked
            # into `resolver` above
            res = BuildResolver(project_root or ".", registry=svc.registry)
        resolved = res.resolve(svc)
        if tag_for is not None:
            resolved = _dc.replace(resolved, tag=tag_for(svc))
        print(f"building {resolved.tag} from {resolved.context}")
        ImageBuilder().build(resolved, on_line=lambda l: print(f"  {l}"))
        if push:
            print(f"pushing {resolved.tag}")
            ImagePusher().push(resolved.tag,
                               on_line=lambda l: print(f"  {l}"))
        tags.append(resolved.tag)
    return tags


def cmd_build(args) -> int:
    flow = _load(args)
    names = [args.name] if args.name else [
        n for n, s in flow.services.items() if s.build is not None]
    if not names:
        print("no services with build{} config", file=sys.stderr)
        return 1
    services = []
    for name in names:
        svc = flow.services.get(name)
        if svc is None or svc.build is None:
            print(f"service {name!r} has no build config", file=sys.stderr)
            return 1
        services.append(svc)
    _build_images(flow, services, getattr(args, "project_root", None),
                  registry=args.registry, push=args.push)
    return 0


def cmd_deploy(args) -> int:
    flow = _load(args)
    stage_name = _stage(args)
    stage = flow.stage(stage_name)
    services = filter_services(stage.services, args.services or [])
    if args.dry_run:
        _print_plan(flow, stage_name, services)
        return 0
    # confirmation gate (deploy.rs:208-216)
    if not args.yes:
        targets = (f"servers {stage.servers}" if stage.servers else "local")
        reply = input(f"deploy {flow.name}/{stage_name} "
                      f"({len(services)} services) to {targets}? [y/N] ")
        if reply.strip().lower() not in ("y", "yes"):
            print("aborted")
            return 1
    # static services ship through the Pages path, not the engine/CP
    # (deploy.rs:265-352)
    from ..runtime.static_site import deploy_static
    static, container = _split_stage(flow, stage, services)
    for svc in static:
        print(f"■ {svc.name} — static site deploy")
        try:
            result = deploy_static(svc,
                                   getattr(args, "project_root", None) or ".",
                                   on_line=lambda line: print(f"  {line}"))
        except (FlowError, CloudError) as e:
            print(f"  {svc.name}: {e}", file=sys.stderr)
            return 1
        print(f"  ✓ deployed" + (f": {result.url}" if result.url else ""))
    if static and not container:
        return 0
    target = args.services or []
    if static:
        target = [s.name for s in container]
    req = DeployRequest(flow=flow, stage_name=stage_name,
                        target_services=target,
                        no_pull=args.no_pull)
    if stage.servers:
        # remote path (deploy.rs:377+): route through the CP
        with CpClient(args.cp) as cp:
            out = cp.request("deploy", "execute",
                             {"request": req.to_dict(),
                              "tenant": args.tenant or
                              (flow.tenant.name if flow.tenant else "default")},
                             timeout=600)
        dep = out["deployment"]
        print(f"deployment {dep['id']}: {dep['status']}")
        if dep.get("placement"):
            for svc, node in sorted(dep["placement"].items()):
                print(f"  {svc} -> {node}")
        return 0 if dep["status"] == "succeeded" else 1
    # local path (deploy.rs:354-375)
    engine = DeployEngine(_backend(args))
    res = engine.execute(req, on_event=_event_printer)
    return 0 if res.ok else 1


# --------------------------------------------------------------------------
# Util commands
# --------------------------------------------------------------------------

def _run_lint(args, *, fmt: str = "text", strict: bool = False) -> int:
    """Shared driver for `fleet lint` and `fleet validate`.

    Exit contract (docs/guide/09-lint.md): 0 = clean (warnings allowed
    unless --strict), 1 = diagnostics at the gating severity, 2 = no
    config found / unreadable project.
    """
    from ..core.discovery import find_project_root
    from ..lint import Severity, lint_project, severity_counts
    try:
        root = find_project_root(getattr(args, "project_root", None))
    except ConfigNotFound:
        # machine consumers always get a parseable document on stdout —
        # a SARIF uploader fed an empty file fails on the parse, not the
        # verdict
        if fmt == "json":
            print(json.dumps({"ok": False, "errors": 0, "warnings": 0,
                              "strict": strict, "diagnostics": [],
                              "reason": "no fleet config found "
                                        "(.fleetflow/fleet.kdl)"}))
        elif fmt == "sarif":
            from ..lint.sarif import to_sarif
            print(json.dumps(to_sarif([]), indent=2))
        print("no fleet config found (.fleetflow/fleet.kdl). "
              "run `fleet init` to create one.", file=sys.stderr)
        return 2
    res = lint_project(root, _stage(args))
    errors, warnings = severity_counts(res.diagnostics)
    # INFO diagnostics (e.g. FF014 bucket-waste advisories) never gate,
    # even under --strict: they report tuning opportunities, not defects
    failing = bool(errors or (strict and warnings))
    if fmt == "sarif":
        # SARIF 2.1.0 so CI (GitHub code scanning et al.) can annotate
        # PRs with the exact spans; exit contract unchanged
        from ..lint.sarif import to_sarif
        print(json.dumps(to_sarif(res.diagnostics), indent=2))
        return 1 if failing else 0
    if fmt == "json":
        print(json.dumps({
            "ok": not failing,
            "errors": errors,
            "warnings": warnings,
            "strict": strict,
            "diagnostics": [d.to_dict() for d in res.diagnostics],
        }, indent=2))
        return 1 if failing else 0
    for d in res.diagnostics:
        stream = sys.stderr if d.severity is Severity.ERROR else sys.stdout
        print(d.format(), file=stream)
    summary = f"{errors} error(s), {warnings} warning(s)"
    if failing:
        print(f"lint: {summary}", file=sys.stderr)
        return 1
    print(f"config valid ({summary})" if res.diagnostics
          else "config valid")
    return 0


def cmd_lint(args) -> int:
    """Static analysis over the project config: coded FF0xx diagnostics
    with file:line spans, no solver, no backend (docs/guide/09-lint.md)."""
    return _run_lint(args, fmt=args.format, strict=args.strict)


def cmd_validate(args) -> int:
    # validate delegates to the lint engine: the placement feasibility it
    # used to check by solving is lint rule FF013 (placement prelint),
    # which runs the same host-greedy baseline with fallback relaxation —
    # plus everything the solver could never tell it (spans, codes, the
    # structural rule set)
    return _run_lint(args, fmt="text", strict=False)


def _baseline_args(q) -> None:
    """Attach the shared accepted-findings-ledger flags (hygiene,
    dataflow and the `all` aggregate read the same file)."""
    q.add_argument("--baseline", metavar="FILE",
                   help="accepted-findings ledger (rule+path+function keys "
                        "with counts; the port's is fleetflow_tpu_torch/"
                        "analysis/audit_baseline.json); matched findings "
                        "are suppressed, stale entries reported")
    q.add_argument("--update-baseline", action="store_true",
                   help="regenerate the baseline file from the current "
                        "findings (defaults to the port's ledger when "
                        "--baseline is not given)")


def cmd_audit(args) -> int:
    """Static analysis over the CODEBASE (not the fleet config): the
    launch-contract auditor (which runs the hot dispatches on the
    top-level --device: the card by default, `cpu` for the plain
    versions) and the host-sync/async hygiene and dataflow passes."""
    if args.audit_cmd == "kernels":
        return _audit_kernels(args)
    if args.audit_cmd == "dataflow":
        return _audit_dataflow(args)
    if args.audit_cmd == "all":
        return _audit_all(args)
    return _audit_hygiene(args)


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _audit_rel() -> str:
    """Diagnostic paths are relative to the checkout holding the package,
    whatever the working directory: the baseline's keys stay stable."""
    return os.path.dirname(_pkg_root())


def _audit_kernels(args) -> int:
    """Run every registered hot dispatch and hold the run to the pinned
    launch contract: in-place writes, kept inputs, output dtypes and
    devices, kernel builds across tiers, the declared host knobs, and on
    the card no upload inside a warm dispatch.

    Exit contract: 0 = contract holds, 1 = violations or contract drift
    (or no card without --device cpu: ``error: ...``), 2 = contract file
    missing/unreadable (run with --update to create)."""
    from ..analysis.auditor import (audit_kernels, contract_diff,
                                    default_contract_path, render_contract)
    contract_path = args.contract or default_contract_path()
    report = audit_kernels(device=args.device)
    for v in report.violations:
        print(f"audit: VIOLATION {v}", file=sys.stderr)
    if report["_host_traffic"] != "measured":
        print(f"audit: host traffic {report['_host_traffic']}",
              file=sys.stderr)
    if args.update:
        if report.violations:
            print("audit: refusing to pin a contract with live "
                  "violations", file=sys.stderr)
            return 1
        with open(contract_path, "w", encoding="utf-8") as f:
            f.write(render_contract(report))
        print(f"audit: contract written to {contract_path}")
        return 0
    try:
        with open(contract_path, encoding="utf-8") as f:
            pinned = json.load(f)
    except (OSError, ValueError) as e:
        print(f"audit: cannot read contract file {contract_path}: {e}\n"
              f"       (generate it with `fleet audit kernels --update`)",
              file=sys.stderr)
        return 2
    drift = contract_diff(report, pinned)
    for d in drift:
        print(f"audit: CONTRACT DRIFT {d}", file=sys.stderr)
    if report.violations or drift:
        print(f"audit: {len(report.violations)} violation(s), "
              f"{len(drift)} contract drift(s). If the change is "
              f"intentional, regenerate with `fleet audit kernels "
              f"--update` and review the golden diff.", file=sys.stderr)
        return 1
    n = sum(len(k["tiers"]) for k in report["kernels"].values())
    print(f"launch contract holds: {len(report['kernels'])} dispatch(es) "
          f"x {n} case(s) on {report['_device']}, 0 violations, 0 drift")
    return 0


def _audit_baseline(diags, args):
    """Accepted-findings ledger plumbing shared by hygiene, dataflow and
    the `all` aggregate. ``--update-baseline`` regenerates the ledger
    from the current findings; ``--baseline FILE`` suppresses accepted
    ones (count-capped per rule+path+function, stale entries reported).

    Returns ``(kept, forced_exit)`` — ``forced_exit`` is None unless the
    baseline itself settles the run: 0 after a write, 2 when the ledger
    is unreadable."""
    from ..analysis import (apply_baseline, default_baseline_path,
                            load_baseline, write_baseline)
    path = getattr(args, "baseline", None)
    if getattr(args, "update_baseline", False):
        path = path or default_baseline_path()
        b = write_baseline(diags, path)
        print(f"audit: baseline written to {path} "
              f"({sum(b.entries.values())} accepted finding(s))")
        return [], 0
    if not path:
        return diags, None
    try:
        base = load_baseline(path)
    except (OSError, ValueError) as e:
        print(f"audit: cannot read baseline {path}: {e}", file=sys.stderr)
        return diags, 2
    kept, suppressed, stale = apply_baseline(diags, base)
    if suppressed:
        print(f"audit: {suppressed} accepted finding(s) suppressed by "
              f"{path}", file=sys.stderr)
    for rule, p, fn in stale:
        print(f"audit: stale baseline entry {rule} {p}:"
              f"{fn or '<module>'} — the code it excused is gone; drop "
              f"it (--update-baseline)", file=sys.stderr)
    return kept, None


def _emit_audit(diags, args, *, tool: str, label: str) -> int:
    """Shared tail of the source-analysis audits: render in the chosen
    format and apply the exit contract (0 clean, 1 findings at the
    gating severity)."""
    from ..lint import Severity, severity_counts
    errors, warnings = severity_counts(diags)
    failing = bool(errors or (args.strict and warnings))
    if args.format == "json":
        print(json.dumps({
            "ok": not failing, "errors": errors, "warnings": warnings,
            "diagnostics": [d.to_dict() for d in diags]}, indent=2))
        return 1 if failing else 0
    if args.format == "sarif":
        from ..lint.sarif import to_sarif
        print(json.dumps(to_sarif(diags, tool=tool), indent=2))
        return 1 if failing else 0
    for d in diags:
        stream = sys.stderr if d.severity is Severity.ERROR else sys.stdout
        print(d.format(), file=stream)
    if failing:
        print(f"{label}: {errors} error(s), {warnings} warning(s)",
              file=sys.stderr)
        return 1
    print(f"{label} clean ({errors} error(s), {warnings} warning(s))")
    return 0


def _audit_hygiene(args) -> int:
    """Run the FJ001-FJ006 hygiene rules over solver/ and cp/ (or
    explicit paths). Exit 0 = clean (warnings allowed unless --strict),
    1 = findings at the gating severity, 2 = unreadable baseline."""
    from ..analysis import hygiene_lint_paths
    roots = args.paths or [os.path.join(_pkg_root(), "solver"),
                           os.path.join(_pkg_root(), "cp")]
    diags = hygiene_lint_paths(roots, rel_to=_audit_rel())
    diags, forced = _audit_baseline(diags, args)
    if forced is not None:
        return forced
    return _emit_audit(diags, args, tool="fleet-audit-hygiene",
                       label="hygiene")


def _audit_dataflow(args) -> int:
    """Run the FJ007, FJ008 and FJ010 interprocedural rules over the whole
    package (or explicit paths): host views read after an in-place write,
    tensors reaching host control flow and deep host syncs under hot
    dispatches. Exit 0 = clean, 1 = findings at the gating severity, 2 =
    internal error (parse failure, unreadable baseline)."""
    from ..analysis import dataflow_lint_paths
    roots = args.paths or [_pkg_root()]
    try:
        diags = dataflow_lint_paths(roots, rel_to=_audit_rel())
    except (OSError, SyntaxError, RecursionError) as e:
        print(f"audit: dataflow pass failed: {e}", file=sys.stderr)
        return 2
    diags, forced = _audit_baseline(diags, args)
    if forced is not None:
        return forced
    return _emit_audit(diags, args, tool="fleet-audit-dataflow",
                       label="dataflow")


def _kernel_audit_diags(args):
    """Run the launch-contract auditor and express its outcome as
    Diagnostic records so `fleet audit all` can merge all three passes
    into one report / one SARIF document. Returns ``(diags,
    internal_error)`` — internal_error mirrors _audit_kernels' exit-2
    leg. A missing card is not an internal error: DeviceUnavailable
    propagates (``error: ...``, exit 1)."""
    from ..lint.diagnostics import Diagnostic, Severity
    diags, internal = [], False
    try:
        from ..analysis.auditor import (audit_kernels, contract_diff,
                                        default_contract_path)
        contract_path = getattr(args, "contract", None) \
            or default_contract_path()
        report = audit_kernels(device=args.device)
        for v in report.violations:
            diags.append(Diagnostic(
                code="FK001", severity=Severity.ERROR, message=str(v),
                rule="launch-contract-violation", stage="audit-kernels"))
        try:
            with open(contract_path, encoding="utf-8") as f:
                pinned = json.load(f)
        except (OSError, ValueError) as e:
            print(f"audit: cannot read contract file {contract_path}: "
                  f"{e}", file=sys.stderr)
            return diags, True
        for d in contract_diff(report, pinned):
            diags.append(Diagnostic(
                code="FK002", severity=Severity.ERROR, message=str(d),
                rule="launch-contract-drift", stage="audit-kernels",
                file=os.path.relpath(contract_path, _audit_rel()),
                hint="if intentional: fleet audit kernels --update"))
    except SolverError:
        raise
    except Exception as e:  # a dispatch that cannot run at all
        print(f"audit: kernels pass failed: {e}", file=sys.stderr)
        internal = True
    return diags, internal


def _audit_all(args) -> int:
    """Aggregate gate: kernels + hygiene + dataflow in one invocation
    with one merged exit contract (0 = every pass clean, 1 = findings at
    the gating severity, 2 = any pass hit an internal error) and — under
    --format sarif — ONE combined SARIF document, one run per pass."""
    from ..analysis import dataflow_lint_paths, hygiene_lint_paths
    from ..lint import Severity, severity_counts
    pkg_root = _pkg_root()

    kdiags, internal_error = _kernel_audit_diags(args)
    hdiags = hygiene_lint_paths([os.path.join(pkg_root, "solver"),
                                 os.path.join(pkg_root, "cp")],
                                rel_to=_audit_rel())
    try:
        ddiags = dataflow_lint_paths([pkg_root], rel_to=_audit_rel())
    except (OSError, SyntaxError, RecursionError) as e:
        print(f"audit: dataflow pass failed: {e}", file=sys.stderr)
        ddiags, internal_error = [], True

    diags, forced = _audit_baseline(kdiags + hdiags + ddiags, args)
    if forced is not None:
        return forced

    errors, warnings = severity_counts(diags)
    failing = bool(errors or (args.strict and warnings))
    exit_code = 2 if internal_error else (1 if failing else 0)
    if args.format == "json":
        print(json.dumps({
            "ok": exit_code == 0, "errors": errors, "warnings": warnings,
            "internal_error": internal_error,
            "diagnostics": [d.to_dict() for d in diags]}, indent=2))
        return exit_code
    if args.format == "sarif":
        from ..lint.sarif import to_sarif
        kset = {id(d) for d in kdiags}
        hset = {id(d) for d in hdiags}
        doc = to_sarif([d for d in diags if id(d) in kset],
                       tool="fleet-audit-kernels")
        for part, tool in (
                ([d for d in diags if id(d) in hset],
                 "fleet-audit-hygiene"),
                ([d for d in diags if id(d) not in kset
                  and id(d) not in hset], "fleet-audit-dataflow")):
            doc["runs"] += to_sarif(part, tool=tool)["runs"]
        print(json.dumps(doc, indent=2))
        return exit_code
    for d in diags:
        stream = sys.stderr if d.severity is Severity.ERROR else sys.stdout
        print(d.format(), file=stream)
    if exit_code:
        print(f"audit all: {errors} error(s), {warnings} warning(s)"
              + (", internal error" if internal_error else ""),
              file=sys.stderr)
        return exit_code
    print(f"audit all clean: kernels + hygiene + dataflow "
          f"({errors} error(s), {warnings} warning(s))")
    return 0


def cmd_solve(args) -> int:
    """Placement preview on the card (no reference analog); the `trace` verb
    renders the solver flight deck instead of solving, the `slots` verb
    shows the device slot manager's residency. A stage literally named
    "trace" or "slots" stays reachable via `fleet solve -s <stage>` (the
    -s flag always means a stage)."""
    if args.stage == "trace" and not getattr(args, "stage_flag", None):
        return cmd_solve_trace(args)
    if args.stage == "slots" and not getattr(args, "stage_flag", None):
        return cmd_solve_slots(args)
    flow = _load(args)
    stage_name = _stage(args)
    stage_obj = flow.stage(stage_name)
    static, container = _split_stage(flow, stage_obj, stage_obj.services)
    if static and not container:
        print(f"stage {stage_name} is static-only "
              f"({', '.join(s.name for s in static)}); nothing to place")
        return 0
    pt = lower_stage(flow, stage_name)
    sched = pick_scheduler(pt.S, pt.N, prefer_gpu=not args.host,
                           device=getattr(args, "device", None))
    placement, _relaxed = place_with_fallback(sched, pt)
    print(f"solved {pt.S} services x {pt.N} nodes via {placement.source} "
          f"in {placement.solve_ms:.1f}ms "
          f"(feasible={placement.feasible}, "
          f"violations={placement.violations})")
    if args.json:
        print(json.dumps(placement.assignment, indent=2))
    else:
        by_node: dict[str, list[str]] = {}
        for svc, node in placement.assignment.items():
            by_node.setdefault(node, []).append(svc)
        for node in sorted(by_node):
            print(f"  {node}: {', '.join(sorted(by_node[node]))}")
    return 0 if placement.feasible else 1


def cmd_solve_slots(args) -> int:
    """`fleet solve slots`: the device slot manager's residency table
    (sched/gpu.py) — which stages hold device-resident problems, their
    bytes against the FLEET_RESIDENT_BYTES budget, idle age and eviction
    counts, and which evicted stages kept a warm re-admission snapshot."""
    with CpClient(args.cp) as cp:
        out = cp.request("health", "solver.slots")
        if args.json:
            print(json.dumps(out, indent=2, default=str))
            return 0
        budget = out.get("budget_bytes", 0)
        used = out.get("resident_bytes", 0)
        print(f"resident {used / 2**20:.1f} MiB / "
              f"{budget / 2**20:.1f} MiB budget, "
              f"{len(out.get('slots', []))}/{out.get('max_slots', 0)} "
              f"slots")
        for s in out.get("slots", []):
            warm = "warm" if s.get("warm") else "cold"
            print(f"  {s['stage']:<28} tier={s['tier']:<10} "
                  f"{s['bytes'] / 2**20:>8.2f} MiB "
                  f"idle={s['idle_s']:>8.1f}s "
                  f"evictions={s['evictions']:<3} {warm}")
        evicted = out.get("evicted", [])
        if evicted:
            print("evicted (host snapshots, warm-seed on re-admission):")
            for e in evicted:
                snap = "snapshot" if e.get("snapshot") else "seed-only"
                print(f"  {e['stage']:<28} S={e['S']:<6} "
                      f"evictions={e['evictions']:<3} {snap}")
        return 0


def cmd_solve_trace(args) -> int:
    """`fleet solve trace`: render the last N solves' in-dispatch
    flight-deck telemetry from the flight recorder (FLEET_TRACE_FILE;
    the solver records one `telemetry` event per adaptive dispatch) as a
    per-sweep-block timeline — why did the gate reject? where did
    acceptance collapse? which tier did the sub-solve pick?"""
    path = getattr(args, "trace_file", None) \
        or os.environ.get("FLEET_TRACE_FILE", "")
    if not path:
        print("no trace file: pass --trace-file or set FLEET_TRACE_FILE",
              file=sys.stderr)
        return 2
    from ..obs.trace import read_trace_files
    try:
        events = read_trace_files(path)
    except FileNotFoundError:
        print(f"trace file {path!r} not found", file=sys.stderr)
        return 2
    solves = [e for e in events
              if e.get("kind") == "telemetry"
              and e.get("name") == "solve.trace"]
    last = max(int(getattr(args, "last", 5) or 5), 1)
    solves = solves[-last:]
    if args.json:
        print(json.dumps(solves, indent=1))
        return 0
    if not solves:
        print("(no solve telemetry recorded — run solves with "
              "FLEET_TRACE_FILE set and FLEET_SOLVE_TRACE_BLOCKS > 0)")
        return 0
    for e in solves:
        f = e.get("fields") or {}
        t = f.get("telemetry") or {}
        head = (f"solve ts={e.get('ts', 0):.3f} "
                f"S={f.get('S')} N={f.get('N')} "
                f"{'warm' if f.get('warm') else 'cold'}"
                f"{' resident' if f.get('resident') else ''} "
                f"path={t.get('path', '?')} "
                f"violations={f.get('violations')} "
                f"total={f.get('total_ms')}ms "
                f"[trace={e.get('trace', '')}]")
        print(head)
        sub = t.get("subsolve")
        if sub:
            print(f"  subsolve: rows={sub.get('rows')} "
                  f"tier={sub.get('tier')} affected={sub.get('affected')} "
                  f"outcome={sub.get('outcome')} ms={sub.get('ms')}")
        if "init" in t:
            # single-chip payloads carry the seed/prologue story; the
            # sharded schema has no prologue fields
            init = t["init"] or {}
            print(f"  seed/prologue: violations={init.get('violations')} "
                  f"soft={init.get('soft')} "
                  f"prerepair_moves={t.get('prerepair_moves')} "
                  f"exit_sweep={t.get('exit_sweep')}")
        else:
            print(f"  mesh={t.get('mesh', '?')} "
                  f"exit_sweep={t.get('exit_sweep')}")
        schema = t.get("schema") or []
        blocks = t.get("blocks") or []
        if not blocks:
            if t.get("exit_sweep") == 0:
                print("  (0-sweep exit: the prologue landed feasible — "
                      "no sweep blocks ran)")
            else:
                # sharded fixed-budget scan path: sweeps ran but there
                # was no block loop to observe
                print("  (no per-block rows recorded for this dispatch)")
            continue
        print("  " + " ".join(f"{c:>14}" for c in schema))
        prev_acc = 0.0
        for row in blocks:
            vals = []
            for c, v in zip(schema, row):
                if c == "accepted":
                    # cumulative on device; render the per-block delta
                    # (the acceptance collapse signal) alongside
                    vals.append(f"{v - prev_acc:+.0f}/{v:.0f}")
                    prev_acc = v
                elif c in ("sweep", "swap_attempts", "swap_accepts"):
                    vals.append(f"{v:.0f}")
                else:
                    vals.append(f"{v:.4g}")
            print("  " + " ".join(f"{v:>14}" for v in vals))
    return 0


def cmd_slo(args) -> int:
    """`fleet slo status`: declared objectives vs observed rolling
    quantiles + fast/slow burn rates (obs/slo.py, docs/guide/10)."""
    with CpClient(args.cp) as cp:
        out = cp.request("health", "slo.status")
        if args.json:
            print(json.dumps(out, indent=2, default=str))
            return 0
        if not out.get("enabled", False):
            print("no SLO engine on this CP (standby, or pre-SLO build)")
            return 1
        objectives = out.get("objectives", [])
        if not objectives:
            print("no objectives declared (add `slo placement-p99-ms=50 "
                  "...` to fleetflowd.kdl)")
        for o in objectives:
            flag = "MET " if o["met"] else "MISS"
            observed = (f"{o['observed']:g}{o['unit']}"
                        if o["observed"] is not None else "-")
            print(f"{flag} {o['name']:<26} objective "
                  f"p{o['quantile'] * 100:g} <= {o['threshold']:g}"
                  f"{o['unit']:<3} observed {observed:<10} "
                  f"burn fast={o['burn_fast']:g} slow={o['burn_slow']:g} "
                  f"({o['samples']} samples)")
        streams = out.get("streams", {})
        if streams:
            print("streams:")
            for name, s in sorted(streams.items()):
                print(f"  {name:<20} samples={s['samples']:<7} "
                      f"p50={s['p50']} p99={s['p99']}")
        return 0 if all(o["met"] for o in objectives) else 1


def cmd_chaos(args) -> int:
    """Chaos harness: seeded fault injection against a simulated fleet
    with fleet-wide invariant checking (docs/guide/08-chaos-harness.md).
    No project
    config needed — the fleet is synthetic and fully determined by
    (scenario, seed, sizes). The world places on the card; `--host` places
    with the host greedy placer."""
    from ..chaos import (build_schedule, run_schedule, scenario_info,
                         SCENARIOS)

    if args.chaos_cmd == "list" or getattr(args, "list", False):
        for name in sorted(SCENARIOS):
            info = scenario_info(name)
            sizing = info["sizing"] or "-"
            print(f"{name:26s} {sizing:36s} {info['description']}")
        return 0
    schedule = build_schedule(args.scenario, args.seed, args.services,
                              args.nodes)
    if args.show_schedule:
        for line in schedule.describe():
            print(line)
        return 0
    print(f"chaos {args.scenario}: seed={args.seed} "
          f"services={args.services} nodes={args.nodes} "
          f"stages={args.stages} pool_min={args.pool_min}")
    report = run_schedule(schedule, services=args.services,
                          nodes=args.nodes, stages=args.stages,
                          pool_min=args.pool_min,
                          device=getattr(args, "device", None),
                          use_gpu=not getattr(args, "host", False))
    s = report.stats
    print(f"  {len(report.events)} events | deploys "
          f"{s['deploys_ok']} ok / {s['deploys_failed']} failed | "
          f"{s['faults']} faults | {s['resolves']} re-solves | "
          f"{s['restarts']} restarts | {s.get('heals', 0)} heals | "
          f"{s['scale_actions']} scale actions")
    print(f"  event-log digest {report.digest()} "
          f"(same seed => same digest)")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report.to_dict(), f, indent=1)
        print(f"  full report -> {args.json}")
    if getattr(args, "tsdb_out", None):
        # the fleet-horizon capture: every series the collector sampled
        # at reconcile boundaries, schema-versioned with its own content
        # digest — written NEXT TO the event-log digest so a repro ships
        # both the causal log and the telemetry it produced
        with open(args.tsdb_out, "w", encoding="utf-8") as f:
            json.dump(report.tsdb or {}, f, indent=1, sort_keys=True)
        n = len((report.tsdb or {}).get("series", []))
        print(f"  tsdb capture ({n} series, digest "
              f"{(report.tsdb or {}).get('digest', '-')[:16]}...) "
              f"-> {args.tsdb_out}")
    if getattr(args, "record_trace", None):
        # the plan-simulate bridge: the run's full primitive timeline +
        # baseline SLO quantiles, replayable against a proposed KDL
        from ..chaos.trace import write_trace
        write_trace(args.record_trace, schedule, report,
                    services=args.services, nodes=args.nodes,
                    stages=args.stages, pool_min=args.pool_min)
        print(f"  traffic trace ({len(schedule.events())} events, "
              f"baseline SLOs) -> {args.record_trace}")
    if report.violations:
        print(f"  {len(report.violations)} INVARIANT VIOLATION(S):")
        for v in report.violations:
            print(f"    {v}")
        return 1
    if getattr(args, "expect_digest", None) \
            and report.digest() != args.expect_digest:
        # CI pins the digest: a drifted event log on the SAME seed means
        # replay determinism broke (or the scenario changed without the
        # pin being updated) — either way, fail loudly
        print(f"  DIGEST MISMATCH: expected {args.expect_digest}")
        return 1
    print("  all invariants hold")
    return 0


def cmd_plan(args) -> int:
    """Capacity planning against recorded traffic
    (docs/guide/18-world-simulator.md): replay a `fleet chaos run
    --record-trace` capture against a PROPOSED flow file through the
    real control-plane paths and report per-stream SLO deltas before
    anything deploys."""
    from ..chaos.simulate import simulate_flow
    from ..core.parser import parse_kdl_file

    flow = parse_kdl_file(args.flow)
    doc = simulate_flow(flow, args.trace, pool_min=args.pool_min,
                        device=getattr(args, "device", None),
                        use_gpu=not getattr(args, "host", False))
    t = doc["trace"]
    print(f"plan simulate: flow {doc['proposal']['flow']!r} "
          f"({doc['proposal']['services']} services, "
          f"{len(doc['proposal']['stages'])} stages) vs trace "
          f"{t['scenario']!r} seed={t['seed']} "
          f"({t['services']}x{t['nodes']})")
    for stream, row in sorted(doc["streams"].items()):
        base = (row.get("baseline") or {}).get("p99")
        prop = (row.get("proposed") or {}).get("p99")
        delta = row.get("delta_p99")
        flag = " REGRESSED" if row.get("regressed") else ""
        print(f"  {stream:<20} baseline p99="
              f"{'-' if base is None else f'{base:g}s'} proposed p99="
              f"{'-' if prop is None else f'{prop:g}s'}"
              + (f" delta={delta:+g}s" if delta is not None else "")
              + flag)
    print(f"  report digest {doc['digest']} "
          f"(same trace+flow => same digest)")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"  full report -> {args.json}")
    if doc["violations"]:
        print(f"  {len(doc['violations'])} INVARIANT VIOLATION(S) "
              f"under the proposal:")
        for v in doc["violations"]:
            print(f"    {v}")
        return 1
    if getattr(args, "expect_digest", None) \
            and doc["digest"] != args.expect_digest:
        print(f"  DIGEST MISMATCH: expected {args.expect_digest}")
        return 1
    if doc["regressions"]:
        print(f"  SLO regression on: {', '.join(doc['regressions'])}")
        return 1
    print("  proposal holds the recorded SLOs")
    return 0


def _fmt_metric(v) -> str:
    if v is None:
        return "-"
    try:
        return f"{float(v):.6g}"
    except (TypeError, ValueError):
        return str(v)


def _print_obs_rows(series: list, header: Optional[str] = None,
                    filter_substr: Optional[str] = None) -> None:
    """Render obs.query aggregate rows grouped by origin: the CP's own
    series first, then one section per agent (series the heartbeat
    shipping labeled `agent=<slug>`) — the shared formatter behind
    `fleet top` and `fleet cp metrics --watch`."""
    if header:
        print(header)
    groups: dict[str, list] = {}
    for row in series:
        if filter_substr and filter_substr not in row["name"]:
            continue
        if row.get("agg", {}).get("count", 0) == 0:
            continue
        groups.setdefault(row["labels"].get("agent", ""), []).append(row)
    for agent in sorted(groups):
        title = f"agent {agent}" if agent else "control plane"
        print(f"-- {title} ({len(groups[agent])} series)")
        for row in groups[agent]:
            labels = {k: v for k, v in row["labels"].items()
                      if k != "agent"}
            sel = ",".join(f'{k}="{v}"'
                           for k, v in sorted(labels.items()))
            sel = "{" + sel + "}" if sel else ""
            agg = row["agg"]
            cols = (f"last={_fmt_metric(agg.get('last'))} "
                    f"mean={_fmt_metric(agg.get('mean'))} "
                    f"p99={_fmt_metric(agg.get('p99'))}")
            if agg.get("rate") is not None:
                cols += f" rate={_fmt_metric(agg['rate'])}/s"
            print(f"  {row['name']}{sel} {cols}")


def cmd_top(args) -> int:
    """Live fleet-wide telemetry: windowed aggregates over every TSDB
    series the CP's collector holds — its own deep gauges plus the
    heartbeat-shipped, agent-labeled series from every connected node
    (docs/guide/10-observability.md). `--once` renders one frame and
    exits (scripting/CI); otherwise redraws every --interval seconds."""
    with CpClient(args.cp) as cp:
        def render() -> int:
            out = cp.request("health", "obs.query",
                             {"window_s": args.window})
            if not out.get("enabled", False):
                print("obs collector is disabled on this CP (standby, "
                      "or started with collector=False)")
                return 1
            st = out.get("collector", {})
            agents = ", ".join(st.get("agents", [])) or "-"
            header = (f"fleet top | window {args.window:g}s | "
                      f"{st.get('series', 0)} series, "
                      f"{st.get('samples_total', 0)} samples | "
                      f"agents: {agents}")
            _print_obs_rows(out["series"], header=header,
                            filter_substr=args.filter)
            return 0

        if args.once:
            return render()
        try:
            while True:
                print("\x1b[2J\x1b[H", end="")
                rc = render()
                if rc != 0:
                    return rc
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def cmd_obs(args) -> int:
    """TSDB query/export face (docs/guide/10-observability.md): windowed
    aggregates (`query`), the series census (`series`), and offline
    dumps (`export` — OpenMetrics text or JSONL)."""
    with CpClient(args.cp) as cp:
        if args.obs_cmd == "series":
            out = cp.request("health", "obs.series")
            if not out.get("enabled", False):
                print("obs collector is disabled on this CP")
                return 1
            if args.json:
                print(json.dumps(out, indent=2))
                return 0
            for s in out["series"]:
                sel = ",".join(f'{k}="{v}"'
                               for k, v in sorted(s["labels"].items()))
                sel = "{" + sel + "}" if sel else ""
                print(f"{s['name']}{sel} [{s['kind']}]")
            st = out["stats"]
            print(f"{st['series']} series, {st['samples_total']} samples "
                  f"({st['dropped_series']} series dropped at the "
                  f"{st['max_series']}-series cap)")
            return 0
        if args.obs_cmd == "export":
            out = cp.request("health", "obs.export",
                             {"format": args.format})
            if not out.get("enabled", False):
                print("obs collector is disabled on this CP")
                return 1
            if args.output:
                with open(args.output, "w", encoding="utf-8") as f:
                    f.write(out["text"])
                print(f"{args.format} dump -> {args.output}")
            else:
                sys.stdout.write(out["text"])
            return 0
        # query
        payload: dict = {"window_s": args.window}
        if args.name:
            payload["name"] = args.name
        if args.label:
            payload["labels"] = dict(
                kv.split("=", 1) for kv in args.label)
        out = cp.request("health", "obs.query", payload)
        if not out.get("enabled", False):
            print("obs collector is disabled on this CP")
            return 1
        if args.json:
            print(json.dumps(out, indent=2))
            return 0
        _print_obs_rows(out["series"])
        return 0


def cmd_admit(args) -> int:
    """Streaming-admission status: the operator's answer to "why is my
    arrival still queued?" — per-tenant depth/age/waits, DRR fairness
    debt, parked + shed counts, and the autoscaler pressure signal
    (docs/guide/14-streaming-admission.md)."""
    with CpClient(args.cp) as cp:
        out = cp.request("deploy", "admit_status")
        if args.json:
            print(json.dumps(out, indent=2, default=str))
            return 0
        if not out.get("enabled", False):
            print("streaming admission is disabled on this CP")
            return 1
        quota = out.get("parked_quota", 0)
        print(f"queued={out['queue_depth']} "
              f"oldest={out['oldest_age_s']:.1f}s "
              f"parked={out['parked']}"
              + (f" (quota={quota})" if quota else ""))
        pres = out.get("pressure", {})
        since = pres.get("since_s")
        print(f"pressure: {'SUSTAINED' if pres.get('sustained') else 'ok'}"
              + (f" (hot for {since:.1f}s)" if since is not None else ""))
        for tenant, t in sorted(out.get("tenants", {}).items()):
            waits = ""
            if t.get("wait_p50_s") is not None:
                waits = (f" wait p50={t['wait_p50_s']:.3f}s "
                         f"p99={t['wait_p99_s']:.3f}s")
            cap = t.get("cap")
            usage = (f" usage={t.get('usage', 0)}/{cap}"
                     + (f" quota_parked={t['parked_quota']}"
                        if t.get("parked_quota") else "")
                     if cap is not None else "")
            print(f"  {tenant:<16} queued={t['queued']:<5} "
                  f"oldest={t['oldest_age_s']:>7.1f}s "
                  f"weight={t['weight']:g} debt={t['deficit']:.1f}"
                  f"{usage}{waits}")
        for key, s in sorted(out.get("streams", {}).items()):
            print(f"  stream {key}: rows={s['rows']} "
                  f"live_streamed={s['live_streamed']} "
                  f"tombstones={s['tombstones']} "
                  f"free_rows={s['free_rows']}")
        st = out.get("stats", {})
        print(f"stats: admitted={st.get('admitted', 0)} "
              f"departed={st.get('departed', 0)} "
              f"sheds={st.get('sheds', 0)} parked={st.get('parked', 0)} "
              f"unparked={st.get('unparked', 0)} "
              f"quota_parked={st.get('quota_parked', 0)} "
              f"solves={st.get('solves', 0)} "
              f"compactions={st.get('compactions', 0)}")
        if out.get("solve_ms_p50") is not None:
            p50, p99 = out["solve_ms_p50"], out["solve_ms_p99"]
            ratio = f" (p99/p50={p99 / p50:.1f}x)" if p50 else ""
            print(f"solve: p50={p50:.1f}ms p99={p99:.1f}ms{ratio}")
        sub = out.get("subsolve") or {}
        if sub:
            # micro-solve dispatch outcomes (solver/subsolve.py):
            # localized is the p99-flattening path; a rising fallback
            # count is the first thing to check when the tail grows
            print("subsolve: " + " ".join(
                f"{k}={v}" for k, v in sub.items()))
        return 0


STARTER_KDL = '''// fleet.kdl — created by `fleet init`
project "{name}"

service "app" {{
    image "nginx"
    version "alpine"
    ports {{ port host=8080 container=80 }}
}}

stage "local" {{
    service "app"
}}
'''


def cmd_events(args) -> int:
    """Pretty-print a flight-recorder file (FLEET_TRACE_FILE JSONL): one
    line per span event, indented by nesting, grep-ably carrying the
    trace id. `--trace` narrows to one operation's timeline."""
    path = args.trace_file or os.environ.get("FLEET_TRACE_FILE", "")
    if not path:
        print("no trace file: pass --trace-file or set FLEET_TRACE_FILE",
              file=sys.stderr)
        return 2
    # read ACROSS the keep-1 rollover (FLEET_TRACE_MAX_MB): a span whose
    # begin predates the rotation still shows whole
    from ..obs.trace import read_trace_files
    try:
        events = read_trace_files(path)
    except FileNotFoundError:
        print(f"trace file {path!r} not found", file=sys.stderr)
        return 2
    if args.trace:
        events = [e for e in events if e.get("trace") == args.trace]
    if args.json:
        print(json.dumps(events, indent=1))
        return 0
    depth: dict[str, int] = {}   # span id -> nesting depth within its trace
    for e in events:
        kind, span_id = e.get("kind", "?"), e.get("span", "")
        if kind == "begin":
            depth[span_id] = depth.get(e.get("parent", ""), -1) + 1
        pad = "  " * depth.get(span_id, 0)
        dur = (f" {e['duration_ms']:.1f}ms"
               if e.get("duration_ms") is not None else "")
        err = f" error={e['error']!r}" if e.get("error") else ""
        fields = e.get("fields") or {}
        # nested payloads (the solve flight deck) have their own viewer
        # (`fleet solve trace`); the timeline stays one line per event
        fstr = " ".join(f"{k}={v}" for k, v in fields.items()
                        if v is not None and not isinstance(v, (dict, list)))
        mark = {"begin": "▶", "end": "✓", "fail": "✗",
                "telemetry": "◆"}.get(kind, "?")
        print(f"{e.get('ts', 0):.3f} {mark} {pad}{e.get('logger', '')} "
              f"{e.get('name', '')}{dur}{err} "
              f"[trace={e.get('trace', '')}]"
              + (f" {fstr}" if fstr else ""))
    if not events:
        print("(no events)" + (f" for trace {args.trace}"
                               if args.trace else ""))
    return 0


def cmd_init(args) -> int:
    """Starter config writer. Interactive wizard on a TTY (the reference's
    ratatui wizard, tui/init.rs:123); direct write with --name or when
    stdin is not a terminal."""
    import os
    from pathlib import Path
    root = Path(getattr(args, "project_root", None) or ".")
    default_name = os.path.basename(root.resolve()) or "myproject"
    interactive = (args.name is None and not args.no_wizard
                   and sys.stdin.isatty())
    if interactive:
        from .wizard import run_wizard
        target = run_wizard(project_root=str(root),
                            default_name=default_name, force=args.force)
        return 0 if target is not None else 1
    target = root / ".fleetflow" / "fleet.kdl"
    if target.exists() and not args.force:
        print(f"{target} already exists (use --force to overwrite)",
              file=sys.stderr)
        return 1
    name = args.name or default_name
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(STARTER_KDL.format(name=name))
    print(f"wrote {target}\ntry: fleet up --dry-run")
    return 0


def cmd_self_update(args) -> int:
    """GitHub-release self-update (the reference's self_update.rs:4)."""
    from .self_update import self_update
    return self_update(dry_run=args.dry_run)


def cmd_mcp(args) -> int:
    from ..mcp.server import serve_stdio
    serve_stdio(project_root=getattr(args, "project_root", None),
                cp_endpoint=args.cp, device=getattr(args, "device", None))
    return 0


def cmd_agent(args) -> int:
    """Run the node agent in the foreground (the reference ships this as
    the separate `fleet-agent` binary, fleet-agent/src/main.rs:40)."""
    import asyncio

    from ..agent import Agent, AgentConfig

    ca_pem = None
    if args.ca:
        with open(args.ca, "rb") as f:
            ca_pem = f.read()
    import socket
    slug = args.slug or socket.gethostname().split(".")[0]
    cfg = AgentConfig(
        cp_host=args.cp_host, cp_port=args.cp_port, slug=slug,
        token=args.token, ca_pem=ca_pem,
        heartbeat_interval_s=args.heartbeat_interval,
        monitor_interval_s=args.monitor_interval,
        restart_threshold=args.restart_threshold,
        deploy_base=args.deploy_base,
        quadlet_unit_dir=getattr(args, "quadlet_unit_dir", None),
        capacity={"cpu": args.cpu, "memory": args.memory, "disk": args.disk},
    )
    # same backend selection as `fleet up` (_backend): FLEET_BACKEND=mock
    # honored, and a dead daemon fails fast instead of registering a node
    # that cannot execute anything. --runtime podman points the CLI
    # backend (and the monitor's inventory) at podman on quadlet nodes —
    # the CLI surfaces are compatible for the subset the backend uses.
    if args.runtime != "docker" and os.environ.get("FLEET_BACKEND") != "mock":
        backend = DockerCliBackend(binary=args.runtime)
        if not backend.ping():
            print(f"{args.runtime} unreachable. start it, or set "
                  "FLEET_BACKEND=mock for a dry environment.",
                  file=sys.stderr)
            return 3
    else:
        backend = _backend(args)
    agent = Agent(cfg, backend=backend)
    print(f"fleet-agent {cfg.slug} -> {cfg.cp_host}:{cfg.cp_port} "
          f"(Ctrl+C to stop)")
    try:
        asyncio.run(agent.run())
    except KeyboardInterrupt:
        pass
    return 0


# --------------------------------------------------------------------------
# Admin: fleet cp ...
# --------------------------------------------------------------------------

def cmd_cp(args) -> int:
    sub = args.cp_command
    if sub == "login":
        creds = CredentialStore()
        endpoint = args.cp or default_endpoint()
        token = args.token
        if not token and getattr(args, "idp", None):
            # OAuth Device Flow against an external IdP (the reference's
            # Auth0 login, fleetflow/src/auth.rs:68-263)
            from .device_flow import DeviceFlowError, device_login
            try:
                tok = device_login(args.idp, args.client_id or "fleetflow",
                                   audience=getattr(args, "audience", None),
                                   scope=getattr(args, "scope", "") or "")
            except DeviceFlowError as e:
                print(f"login failed: {e}", file=sys.stderr)
                return 1
            token = tok["access_token"]
        if not token and args.secret:
            # mint locally from a shared secret (self-issued HS256 path)
            from ..cp.auth import TokenAuth
            token = TokenAuth(args.secret).issue(
                args.email or "operator@local", ["admin:all"],
                tenant=args.tenant or "default")
        if not token:
            print("provide --token, --secret, or --idp", file=sys.stderr)
            return 1
        creds.save_token(endpoint, token, email=args.email or "")
        print(f"credentials saved for {endpoint}")
        return 0
    if sub == "logout":
        ok = CredentialStore().forget(args.cp or default_endpoint())
        print("logged out" if ok else "no stored credentials")
        return 0
    if sub == "token":
        # scoped minting: per-node agent identities make the registry's
        # slug->principal anti-hijack fence effective (agent_registry.py
        # register); a shared admin:all token would give every node the
        # same subject
        from ..cp.auth import TokenAuth
        perms = [s.strip() for s in args.permissions.split(",") if s.strip()]
        print(TokenAuth(args.secret).issue(
            args.email, perms, tenant=args.tenant, ttl_s=args.ttl))
        return 0
    if sub == "daemon":
        from ..daemon.__main__ import main as daemon_main
        argv = [args.daemon_command]
        if args.config:
            argv += ["-c", args.config]
        return daemon_main(argv)

    # registry verbs that only read the local fleet-registry.kdl must not
    # demand a live CP (status/sync do)
    if sub == "registry" and args.verb in ("list", "solve", "deploy"):
        return _cmd_cp_registry(None, args)

    # everything else talks to the CP
    with CpClient(args.cp) as cp:
        return _cp_dispatch(cp, args)


def _need(value, what: str):
    """nargs='?' positionals must not reach the CP as None."""
    if value in (None, ""):
        raise ValueError(f"missing required argument: {what}")
    return value


def _cp_dispatch(cp: CpClient, args) -> int:
    sub = args.cp_command

    def show(obj) -> int:
        print(json.dumps(obj, indent=2, default=str))
        return 0

    if sub == "status":
        return show(cp.request("health", "overview"))
    if sub == "replication":
        # replication topology at a glance: role, fencing epoch, journal
        # seq, and per-standby lag (docs/guide/13-cp-replication.md)
        out = cp.request("replication", "status")
        if getattr(args, "json", False):
            return show(out)
        print(f"role={out.get('role')} epoch={out.get('epoch')} "
              f"seq={out.get('seq')}")
        if out.get("role") == "standby":
            print(f"  primary {out.get('primary')} | applied "
                  f"{out.get('applied', 0)} entries | "
                  f"{out.get('snapshot_catchups', 0)} snapshot catch-ups")
            lease = out.get("primary_lease") or {}
            if lease:
                print(f"  primary lease: {lease.get('state')} "
                      f"(remaining {lease.get('lease_remaining_s')}s)")
        for sb in out.get("standbys", []):
            print(f"  standby {sb['identity']:<20} acked={sb['acked_seq']} "
                  f"lag={sb['lag']}")
        if out.get("role") == "primary" and not out.get("standbys"):
            print("  no standbys attached (single point of failure: see "
                  "docs/guide/13-cp-replication.md)")
        return 0
    if sub == "heal":
        out = cp.request("health", "heal.status")
        if not out.get("enabled", False):
            print("self-healing is disabled on this CP "
                  "(`self-heal true` in fleetflowd.kdl)")
            return 1
        if getattr(args, "json", False):
            return show(out)
        repl = out.get("replication") or {}
        if repl:
            standbys = repl.get("standbys")
            lag = (f" standbys={len(standbys)} "
                   f"max_lag={max((s['lag'] for s in standbys), default=0)}"
                   if standbys is not None else "")
            print(f"replication: role={repl.get('role')} "
                  f"epoch={repl.get('epoch')}{lag}")
        det = out.get("detector", {})
        agents = det.get("agents", {})
        cfg = det.get("config", {})
        print(f"lease={cfg.get('lease_s')}s "
              f"grace={cfg.get('suspect_grace_s')}s "
              f"flap_threshold={cfg.get('flap_threshold')} "
              f"damp_hold={cfg.get('damp_hold_s')}s")
        for slug, a in sorted(agents.items()):
            damped = " DAMPED" if a.get("damped") else ""
            print(f"  {slug:<20} {a['state']:<8} "
                  f"lease_remaining={a['lease_remaining_s']:>8.1f}s "
                  f"verdicts={a['recent_verdicts']}{damped}")
        work = out.get("work", [])
        if work:
            print("convergence work:")
            for w in work:
                state = ("parked" if w["parked"]
                         else f"retry in {w['retry_in_s']}s")
                err = f" ({w['last_error']})" if w.get("last_error") else ""
                print(f"  {w['stage']:<30} {state} attempt={w['attempt']} "
                      f"reason={w['reason']}{err}")
        else:
            print("convergence work: none (fleet converged)")
        s = out.get("stats", {})
        print(f"stats: dead={s.get('verdicts_dead', 0)} "
              f"online={s.get('verdicts_online', 0)} "
              f"resolves={s.get('resolves', 0)} "
              f"redeliveries_ok={s.get('redeliveries_ok', 0)} "
              f"retried={s.get('redeliveries_retried', 0)} "
              f"parked={s.get('parked', 0)}")
        sh = out.get("shards") or {}
        if sh.get("census"):
            # per-shard occupancy/in-flight (docs/guide/17-cp-sharding):
            # which partition of the fleet is loaded or behind
            print(f"shards: count={sh.get('count', 1)} "
                  f"debt={sh.get('debt', 0)}")
            for row in sh["census"]:
                print(f"  shard {row['shard']:<3} "
                      f"agents={row['agents']:<6} "
                      f"inflight={row['inflight']}")
        res = out.get("resident") or {}
        if res:
            print(f"resident: delta_reuse={res.get('delta_reuse', 0)} "
                  f"cold={res.get('cold_stagings', 0)} "
                  f"host_transfers={res.get('host_transfers', 0)}")
            sub = res.get("subsolve") or {}
            if sub:
                # where the heal path's churn re-solves were dispatched:
                # localized = active-set mini anneal, fallback_* = the
                # full fused path ran and why (docs/guide/11)
                print("subsolve: " + " ".join(
                    f"{k}={v}" for k, v in sub.items()))
        return 0
    if sub == "metrics":
        # the same registry GET /metrics serves, fetched over the channel
        # protocol and printed as name{labels} value lines (--format json
        # for the full structured snapshot with HELP text and histogram
        # sums; --json kept as an alias). --watch N re-renders every N
        # seconds THROUGH THE TSDB query path (obs.query), so each line
        # carries windowed rate/p99 context a point snapshot can't
        def _render_snapshot() -> int:
            snap = cp.request("health", "metrics")["metrics"]
            if getattr(args, "json", False) \
                    or getattr(args, "format", "text") == "json":
                return show(snap)
            for name, fam in sorted(snap.items()):
                for v in fam["values"]:
                    labels = ",".join(
                        f'{k}="{val}"'
                        for k, val in sorted(v["labels"].items()))
                    sel = f"{{{labels}}}" if labels else ""
                    if fam["type"] == "histogram":
                        print(f"  {name}{sel} count={v['count']} "
                              f"sum={v['sum']:.6g}")
                    else:
                        print(f"  {name}{sel} {v['value']:g}")
            return 0

        watch = getattr(args, "watch", None)
        if not watch:
            return _render_snapshot()
        try:
            while True:
                out = cp.request("health", "obs.query",
                                 {"window_s": max(float(watch) * 6, 30.0)})
                print("\x1b[2J\x1b[H", end="")
                if not out.get("enabled", False):
                    # no collector on this CP (standby, or disabled):
                    # degrade to re-printing the point snapshot
                    _render_snapshot()
                else:
                    _print_obs_rows(out["series"],
                                    header=f"every {watch}s | window "
                                           f"{out['window_s']:g}s | "
                                           "ctrl-c to exit")
                time.sleep(float(watch))
        except KeyboardInterrupt:
            return 0
    if sub == "tenant":
        verb = args.verb
        if verb == "status":
            # TenantCommands::Status: the tenant's projects + users at a
            # glance (main.rs:308)
            tenant = args.name or args.tenant or "default"
            projects = cp.request("project", "list",
                                  {"tenant": tenant})["projects"]
            users = cp.request("tenant", "user.list",
                               {"tenant": tenant})["users"]
            return show({"tenant": tenant, "projects": projects,
                         "users": users})
        if verb == "list":
            return show(cp.request("tenant", "list")["tenants"])
        if verb == "create":
            return show(cp.request("tenant", "create",
                                   {"name": _need(args.name, "tenant name")}))
        if verb == "delete":
            return show(cp.request("tenant", "delete",
                                   {"name": _need(args.name, "tenant name")}))
        if verb == "users":
            return show(cp.request("tenant", "user.list",
                                   {"tenant": _need(args.name, "tenant name")})["users"])
    if sub == "project":
        if args.verb == "list":
            return show(cp.request("project", "list",
                                   {"tenant": args.tenant})["projects"])
        if args.verb == "create":
            return show(cp.request("project", "create",
                                   {"name": _need(args.name, "project name"),
                                    "tenant": args.tenant or "default"}))
        if args.verb == "show":
            return show(cp.request("project", "get",
                                   {"name": _need(args.name, "project name"),
                                    "tenant": args.tenant or "default"}))
    if sub == "server":
        verb = args.verb
        if verb == "list":
            rows = cp.request("server", "list")["servers"]
            for s in rows:
                print(f"  {s['slug']:<20} {s['status']:<10} "
                      f"{s['scheduling_state']:<12} "
                      f"cpu {s['allocated']['cpu']:.1f}/{s['capacity']['cpu']}")
            return 0
        if verb == "status":
            return show(cp.request("server", "get",
                                   {"slug": _need(args.name, "server slug")}))
        if verb == "check":
            return show(cp.request("server", "check_all"))
        if verb == "ping":
            return show(cp.request("server", "ping",
                                   {"slug": _need(args.name, "server slug")}))
        if verb in ("boot", "shutdown"):
            return show(cp.request("server", verb,
                                   {"slug": _need(args.name, "server slug")},
                                   timeout=120))
        if verb in ("cordon", "uncordon", "drain"):
            return show(cp.request("server", verb,
                                   {"slug": _need(args.name, "server slug")}))
        if verb == "register":
            return show(cp.request("server", "register",
                                   {"slug": _need(args.name, "server slug")}))
        if verb == "delete":
            return show(cp.request("server", "delete",
                                   {"slug": _need(args.name, "server slug")}))
        if verb == "provision":
            return show(cp.request("server", "provision", {
                "slug": _need(args.name, "server slug"),
                "provider": _need(getattr(args, "provider", None),
                                  "--provider"),
                "tenant": args.tenant or "default",
            }, timeout=600))
        if verb == "deprovision":
            return show(cp.request("server", "deprovision",
                                   {"slug": _need(args.name, "server slug")},
                                   timeout=600))
        if verb == "pool-create":
            payload = {"name": _need(args.name, "pool name"),
                       "tenant": args.tenant or "default"}
            labels = {}
            if getattr(args, "provider", None):
                labels["provider"] = args.provider
            if labels:
                payload["preferred_labels"] = labels
            if getattr(args, "min", None) is not None:
                payload["min_servers"] = args.min
            if getattr(args, "max", None) is not None:
                payload["max_servers"] = args.max
            return show(cp.request("server", "pool.create", payload))
        if verb == "pool-list":
            rows = cp.request("server", "pool.list")["pools"]
            for w in rows:
                print(f"  {w['name']:<16} min={w['min_servers']} "
                      f"max={w['max_servers']} "
                      f"labels={w['preferred_labels']}")
            return 0
    if sub == "agents":
        return show(cp.request("health", "overview")["agents"])
    if sub == "alerts":
        return show(cp.request("health", "alerts",
                               {"tenant": getattr(args, "tenant", None)})
                    ["alerts"])
    if sub == "cost":
        if args.verb == "list":
            return show(cp.request("cost", "list",
                                   {"tenant": args.tenant,
                                    "month": args.month})["entries"])
        if args.verb == "summary":
            return show(cp.request("cost", "summary",
                                   {"tenant": args.tenant or "default",
                                    "month": _need(args.month, "--month")}))
        if args.verb in ("add", "record"):
            return show(cp.request("cost", "add",
                                   {"tenant": args.tenant or "default",
                                    "month": _need(args.month, "--month"),
                                    "amount": _need(args.amount, "--amount"),
                                    "server": args.name or ""}))
    if sub == "dns":
        if args.verb == "list":
            return show(cp.request("dns", "list",
                                   {"zone": args.zone})["records"])
        if args.verb == "create":
            return show(cp.request("dns", "create",
                                   {"zone": _need(args.zone, "--zone"),
                                    "name": _need(args.name, "--name"),
                                    "content": _need(args.content, "--content"),
                                    "record_type": args.type}))
        if args.verb == "delete":
            return show(cp.request("dns", "delete",
                                   {"zone": _need(args.zone, "--zone"),
                                    "name": _need(args.name, "--name")}))
        if args.verb == "sync":
            return show(cp.request("dns", "sync", {}))
    if sub == "placement":
        if args.verb == "state":
            return show(cp.request("placement", "reservations", {}))
        if args.verb == "explain":
            out = cp.request("placement", "explain",
                             {"stage": _need(args.stage, "--stage"),
                              "service": _need(args.service, "--service")})
            ch = out["chosen"]
            rank = (f"rank {out['chosen_rank']}" if out["chosen_rank"]
                    else "NOT FEASIBLE on its node")
            print(f"{out['service']} -> {ch['node']} "
                  f"({rank} of "
                  f"{out['blocked_counts']['feasible']} feasible / "
                  f"{out['blocked_counts']['total_nodes']} nodes, "
                  f"strategy {out['strategy']})")
            print(f"  score {ch['score']}  strategy_term "
                  f"{ch['strategy_term']}  preference {ch['preference']}  "
                  f"coloc_mates {ch['coloc_mates']}")
            bc = out["blocked_counts"]
            print(f"  blocked: {bc['ineligible']} ineligible, "
                  f"{bc['invalid']} offline, {bc['capacity']} full, "
                  f"{bc['conflicts']} conflicting")
            for alt in out["alternatives"]:
                print(f"  alt {alt['node']}: score {alt['score']} "
                      f"(pref {alt['preference']}, "
                      f"coloc {alt['coloc_mates']})")
            return 0
    if sub == "volume":
        if args.verb == "list":
            return show(cp.request("volume", "list", {})["volumes"])
        if args.verb == "adopt":
            return show(cp.request("volume", "adopt",
                                   {"server": _need(args.server, "--server"),
                                    "name": _need(args.name, "--name")}))
    if sub == "build":
        if args.verb == "submit":
            return show(cp.request("build", "submit",
                                   {"repo": _need(args.repo, "--repo"),
                                    "image_tag": _need(args.tag, "--tag"),
                                    "ref": args.ref,
                                    "push": args.push}))
        if args.verb == "list":
            return show(cp.request("build", "list")["jobs"])
        if args.verb == "show":
            return show(cp.request("build", "show",
                                   {"job": _need(args.name, "job id")}))
        if args.verb == "logs":
            return show(cp.request("build", "logs",
                                   {"job": _need(args.name, "job id")}))
        if args.verb == "cancel":
            return show(cp.request("build", "cancel",
                                   {"job": _need(args.name, "job id")}))
    if sub == "stage":
        if args.verb == "status":
            return show(cp.request("stage", "status",
                                   {"stage": _need(args.name, "stage id")}))
        if args.verb == "adopt":
            return show(cp.request("stage", "adopt",
                                   {"stage": _need(args.name, "stage id")}))
    if sub == "remote":
        # SSH remote-exec deploys for agent-less servers (reference
        # RemoteCommands: deploy + history)
        if args.verb == "deploy":
            payload = {
                "server": _need(args.server, "--server"),
                "path": _need(args.path, "--path"),
                "stage": _need(args.stage_name, "--stage"),
                "tenant": args.tenant or "default",
                "ssh_user": args.ssh_user,
            }
            if args.project:   # else the handler defaults to the path
                payload["project"] = args.project
            out = cp.request("deploy", "run", payload, timeout=600)
            dep = out["deployment"]
            print(f"deployment {dep['id']}: {dep['status']}")
            return 0 if dep["status"] == "succeeded" else 1
        if args.verb == "history":
            rows = cp.request("deploy", "history",
                              {"limit": args.limit})["deployments"]
            for d in rows:
                print(f"  {d['id']:<28} {d['status']:<10} "
                      f"{', '.join(d.get('services') or [])}")
            return 0
    if sub == "registry":
        return _cmd_cp_registry(cp, args)
    print(f"unknown cp command {sub!r}", file=sys.stderr)
    return 2


def _cmd_cp_registry(cp: CpClient, args) -> int:
    """Multi-fleet ops (commands/registry.rs:250-417)."""
    from ..registry import find_registry, parse_registry_file
    path = find_registry()
    if path is None:
        print("no fleet-registry.kdl found", file=sys.stderr)
        return 1
    reg = parse_registry_file(str(path))
    if args.verb == "list":
        for name, entry in sorted(reg.fleets.items()):
            routes = reg.routes_for_fleet(name)
            print(f"  {name:<16} {entry.path}  "
                  f"[{', '.join(f'{r.stage}->{r.server}' for r in routes)}]")
        return 0
    if args.verb == "status":
        out = cp.request("health", "overview")
        print(f"registry {path}: {len(reg.fleets)} fleets, "
              f"{len(reg.servers)} servers; CP sees "
              f"{out['online']}/{out['servers']} online")
        return 0
    if args.verb == "solve":
        from ..registry import aggregate_fleets
        from ..sched import pick_scheduler, place_with_fallback
        pt, index = aggregate_fleets(reg)
        placement, _ = place_with_fallback(
            pick_scheduler(pt.S, pt.N, device=getattr(args, "device", None)),
            pt)
        print(f"aggregate: {pt.S} services x {pt.N} nodes "
              f"feasible={placement.feasible} via {placement.source}")
        return 0 if placement.feasible else 1
    if args.verb == "sync":
        from ..registry import sync_servers_payloads
        for payload in sync_servers_payloads(reg):
            out = cp.request("server", "register", payload)
            print(f"  synced {payload['slug']}")
        return 0
    if args.verb == "deploy":
        from ..registry import deploy_routes
        results = deploy_routes(reg, fleet=args.name,
                                stage=getattr(args, "stage", None),
                                dry_run=args.dry_run, on_line=print)
        bad = [r for r in results if not r.ok]
        for r in bad:
            print(f"  FAILED {r.route.fleet}/{r.route.stage}: {r.error}",
                  file=sys.stderr)
        if not results:
            print("no matching routes", file=sys.stderr)
        return 0 if results and not bad else 1
    print(f"unknown registry verb {args.verb!r}", file=sys.stderr)
    return 2


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fleet",
        description="fleetflow-tpu: GPU-native container-fleet orchestration")
    ap.add_argument("--project-root", help="project directory (default: walk up)")
    ap.add_argument("--device", default=None,
                    help="the GPU solver's device (default: the card; "
                         "`cpu` runs its plain versions on the host)")
    ap.add_argument("--mock", action="store_true",
                    help="use the in-memory container backend")
    sub = ap.add_subparsers(dest="command", required=True)

    def stage_args(p, positional=True):
        if positional:
            p.add_argument("stage", nargs="?", help="stage name")
        p.add_argument("-s", dest="stage_flag", help="stage (or FLEET_STAGE)")

    # Daily
    p = sub.add_parser("up", help="start a stage's services")
    stage_args(p)
    p.add_argument("-n", "--service", dest="services", action="append")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--no-pull", action="store_true")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="stop a stage")
    stage_args(p)
    p.add_argument("-n", "--service", dest="services", action="append")
    p.add_argument("--remove", action="store_true",
                   help="quadlet backend: also delete the generated units")
    p.add_argument("--cp", help="CP endpoint host:port (a servers-stage "
                               "tears down through the control plane, "
                               "same routing as deploy)")
    p.add_argument("--local", action="store_true",
                   help="force the local teardown path (e.g. to clean up "
                        "a local `fleet up` of a servers-stage)")
    p.add_argument("--tenant")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("restart", help="restart services")
    stage_args(p)
    p.add_argument("-n", "--service", dest="services", action="append")
    p.add_argument("--cp", help="CP endpoint host:port (a servers-stage "
                               "restarts containers on their owning nodes)")
    p.add_argument("--local", action="store_true",
                   help="force the local docker restart path")
    p.set_defaults(fn=cmd_restart)

    p = sub.add_parser("ps", help="list containers")
    stage_args(p)
    p.add_argument("--global", dest="global_", action="store_true",
                   help="all containers known to the CP")
    p.add_argument("--project", help="filter CP view by project")
    p.add_argument("--cp", help="CP endpoint host:port")
    p.set_defaults(fn=cmd_ps)

    p = sub.add_parser("logs", help="container logs")
    p.add_argument("service")
    stage_args(p, positional=False)
    p.add_argument("--tail", type=int, default=100)
    p.add_argument("-f", "--follow", action="store_true",
                   help="stream new lines until Ctrl+C (logs.rs follow)")
    p.add_argument("--since", help="only lines after this (e.g. 10m, 2h, "
                   "RFC3339 timestamp)")
    p.add_argument("--cp", help="CP endpoint host:port (a servers-stage "
                               "fetches live logs from the owning nodes)")
    p.add_argument("--local", action="store_true",
                   help="force the local docker logs path")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("exec", help="exec into a service container")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="keep stdin attached")
    p.add_argument("-t", "--tty", action="store_true",
                   help="allocate a pseudo-TTY")
    stage_args(p, positional=False)
    p.add_argument("service")
    # REMAINDER: the command may carry its own flags (`fleet exec web ls -la`)
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_exec)

    # Ship
    p = sub.add_parser("build", help="build service images")
    stage_args(p)
    p.add_argument("-n", "--name", help="one service (default: all with build{})")
    p.add_argument("--push", action="store_true")
    p.add_argument("--registry")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("deploy", help="deploy a stage (local or via CP)")
    stage_args(p)
    p.add_argument("-n", "--service", dest="services", action="append")
    p.add_argument("-y", "--yes", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--no-pull", action="store_true")
    p.add_argument("--tenant")
    p.add_argument("--cp", help="CP endpoint host:port")
    p.set_defaults(fn=cmd_deploy)

    # Util
    p = sub.add_parser("lint", help="static analysis of the fleet config "
                                    "(coded diagnostics with source spans)")
    stage_args(p, positional=False)
    p.add_argument("--format", choices=["text", "json", "sarif"],
                   default="text",
                   help="diagnostic output format (default: text)")
    p.add_argument("--strict", action="store_true",
                   help="treat warnings as errors (exit 1)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("audit", help="static analysis of the CODEBASE: "
                       "launch contracts of the hot dispatches (run on "
                       "--device) + host-sync/async hygiene and dataflow")
    auds = p.add_subparsers(dest="audit_cmd", required=True)
    q = auds.add_parser("kernels", help="run the hot dispatches and check "
                        "their in-place/keep/upload/build contracts against "
                        "the pinned launch contract")
    q.add_argument("--contract",
                   help="contract file (default: fleetflow_tpu_torch/"
                        "analysis/launch_contract.json)")
    q.add_argument("--update", action="store_true",
                   help="regenerate the contract file from this tree "
                        "(review the diff: every change is a host knob, an "
                        "in-place write or an output)")
    q.set_defaults(fn=cmd_audit)
    q = auds.add_parser("hygiene", help="FJ001+ AST rules over solver/ "
                        "and cp/ (host syncs in hot dispatches, blocking "
                        "calls in async handlers, awaits under the store "
                        "lock)")
    q.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: solver/ and cp/)")
    q.add_argument("--format", choices=["text", "json", "sarif"],
                   default="text")
    q.add_argument("--strict", action="store_true",
                   help="treat warnings as errors (exit 1)")
    _baseline_args(q)
    q.set_defaults(fn=cmd_audit)
    q = auds.add_parser("dataflow", help="FJ007/FJ008/FJ010 "
                        "interprocedural rules over the whole package: "
                        "host views read after an in-place write, tensors "
                        "in host control flow and deep host syncs under "
                        "hot dispatches")
    q.add_argument("paths", nargs="*",
                   help="files/dirs to analyze (default: the whole "
                        "fleetflow_tpu_torch package, so cross-module "
                        "calls resolve)")
    q.add_argument("--format", choices=["text", "json", "sarif"],
                   default="text")
    q.add_argument("--strict", action="store_true",
                   help="treat warnings as errors (exit 1)")
    _baseline_args(q)
    q.set_defaults(fn=cmd_audit)
    q = auds.add_parser("all", help="aggregate gate: kernels + hygiene + "
                        "dataflow in one invocation, one merged exit "
                        "contract (0 clean / 1 findings / 2 internal "
                        "error) and one combined SARIF document")
    q.add_argument("--format", choices=["text", "json", "sarif"],
                   default="text")
    q.add_argument("--strict", action="store_true",
                   help="treat warnings as errors (exit 1)")
    q.add_argument("--contract",
                   help="launch contract file (default: fleetflow_tpu_"
                        "torch/analysis/launch_contract.json)")
    _baseline_args(q)
    q.set_defaults(fn=cmd_audit)

    p = sub.add_parser("validate", help="load config + check placements "
                                        "(delegates to `fleet lint`)")
    stage_args(p, positional=False)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("solve", help="GPU placement preview; "
                       "`fleet solve trace` renders the in-dispatch "
                       "flight-deck telemetry of the last N solves, "
                       "`fleet solve slots` the device slot manager's "
                       "residency table (docs/guide/10+16; a stage "
                       "named 'trace'/'slots' stays reachable via -s)")
    stage_args(p)
    p.add_argument("--host", action="store_true", help="force host greedy")
    p.add_argument("--json", action="store_true")
    p.add_argument("--cp", help="CP endpoint host:port (`slots` only)")
    p.add_argument("--trace-file",
                   help="flight-recorder file (default: FLEET_TRACE_FILE;"
                        " `fleet solve trace` only)")
    p.add_argument("--last", type=int, default=5, metavar="N",
                   help="solves to render, newest last (trace only)")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("agent", help="run the node agent (foreground)")
    p.add_argument("--cp-host", default="127.0.0.1")
    p.add_argument("--cp-port", type=int, default=4510)
    p.add_argument("--slug", default=None,
                   help="node slug (default: hostname)")
    p.add_argument("--token", help="CP auth token")
    p.add_argument("--ca", help="path to the mesh-CA public cert (TLS)")
    p.add_argument("--cpu", type=float, default=2.0)
    p.add_argument("--memory", type=float, default=4096.0)
    p.add_argument("--disk", type=float, default=40960.0)
    p.add_argument("--heartbeat-interval", type=float, default=30.0)
    p.add_argument("--monitor-interval", type=float, default=30.0)
    p.add_argument("--restart-threshold", type=int, default=3)
    p.add_argument("--deploy-base", default="~/.fleetflow/deploys")
    p.add_argument("--runtime", default="docker",
                   help="container binary the agent drives and monitors "
                        "(docker|podman; quadlet nodes run podman)")
    p.add_argument("--quadlet-unit-dir",
                   help="systemd unit dir for quadlet deploys "
                        "(default: the user systemd dir)")
    p.set_defaults(fn=cmd_agent)

    p = sub.add_parser("events", help="pretty-print a flight-recorder "
                       "trace file (FLEET_TRACE_FILE span events)")
    p.add_argument("--trace-file", help="path to the JSONL flight-recorder "
                   "file (default: $FLEET_TRACE_FILE)")
    p.add_argument("--trace", help="only events of this trace id")
    p.add_argument("--json", action="store_true",
                   help="raw JSON events instead of the timeline view")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("init", help="write a starter fleet.kdl")
    p.add_argument("--name")
    p.add_argument("--force", action="store_true")
    p.add_argument("--no-wizard", action="store_true",
                   help="skip the interactive wizard even on a TTY")
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("self-update",
                       help="update fleet from GitHub releases")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_self_update)

    p = sub.add_parser("mcp", help="run the MCP server on stdio")
    p.add_argument("--cp", help="CP endpoint host:port")
    p.set_defaults(fn=cmd_mcp)

    # Admin
    p = sub.add_parser("cp", help="control-plane administration")
    p.add_argument("--cp", dest="cp", help="CP endpoint host:port")
    cps = p.add_subparsers(dest="cp_command", required=True)

    q = cps.add_parser("login")
    q.add_argument("--token")
    q.add_argument("--secret", help="shared secret to mint a token")
    q.add_argument("--idp", help="IdP base URL for OAuth device-flow login")
    q.add_argument("--client-id", help="OAuth client id for --idp")
    q.add_argument("--audience", help="OAuth audience for --idp")
    q.add_argument("--scope", help="OAuth scopes for --idp")
    q.add_argument("--email")
    q.add_argument("--tenant")
    q = cps.add_parser("logout")
    q = cps.add_parser("token", help="mint a scoped HS256 token (e.g. a "
                       "per-node agent identity: --email agent@<slug> "
                       "--permissions write:agent)")
    q.add_argument("--secret", required=True,
                   help="the CP's shared HS256 secret")
    q.add_argument("--email", required=True,
                   help="token subject (use a distinct one per node agent)")
    q.add_argument("--permissions", default="write:agent",
                   help="comma-separated grants (default: write:agent)")
    q.add_argument("--tenant", default="default")
    q.add_argument("--ttl", type=float, default=86400.0 * 365,
                   help="lifetime in seconds (default: one year)")
    q = cps.add_parser("status")
    q = cps.add_parser("heal", help="self-healing status: lease table, "
                       "pending/parked convergence work "
                       "(docs/guide/12-self-healing.md)")
    q.add_argument("verb", choices=["status"])
    q.add_argument("--json", action="store_true",
                   help="raw heal.status payload")
    q = cps.add_parser("metrics", help="dump the CP metrics registry "
                       "(the JSON face of GET /metrics)")
    q.add_argument("--json", action="store_true",
                   help="full structured snapshot with HELP text "
                        "(alias for --format json)")
    q.add_argument("--format", choices=["text", "json"], default="text",
                   help="output shape (default: text lines)")
    q.add_argument("--watch", type=float, metavar="N",
                   help="re-render every N seconds through the TSDB "
                        "query path (windowed rate/p99 per series)")
    q = cps.add_parser("replication", help="replication status: role, "
                       "fencing epoch, standby lag "
                       "(docs/guide/13-cp-replication.md)")
    q.add_argument("verb", choices=["status"])
    q.add_argument("--json", action="store_true",
                   help="raw replication.status payload")
    q = cps.add_parser("daemon")
    q.add_argument("daemon_command",
                   choices=["run", "start", "stop", "status"])
    q.add_argument("-c", "--config")
    q = cps.add_parser("agents")
    q = cps.add_parser("alerts")
    q.add_argument("--tenant")

    for group, verbs in [
        ("tenant", ["status", "list", "create", "delete", "users"]),
        ("project", ["list", "create", "show"]),
        ("server", ["list", "register", "status", "check", "ping", "boot",
                    "shutdown", "cordon", "uncordon", "drain",
                    "delete", "provision", "deprovision", "pool-create",
                    "pool-list"]),
        ("stage", ["status", "adopt"]),
    ]:
        q = cps.add_parser(group)
        q.add_argument("verb", choices=verbs)
        q.add_argument("name", nargs="?")
        q.add_argument("--tenant")
        if group == "server":
            q.add_argument("--provider",
                           help="cloud provider for provision (sakura|aws)")
            q.add_argument("--min", type=int, help="pool min servers")
            q.add_argument("--max", type=int, help="pool max servers")

    q = cps.add_parser("cost")
    # "record" = the reference's verb (CostCommands::Record); "add" kept
    q.add_argument("verb", choices=["list", "summary", "add", "record"])
    q.add_argument("--month")
    q.add_argument("--amount", type=float)
    q.add_argument("--tenant")
    q.add_argument("--name")

    q = cps.add_parser("dns")
    q.add_argument("verb", choices=["list", "create", "delete", "sync"])
    q.add_argument("--zone")
    q.add_argument("--name")
    q.add_argument("--content")
    q.add_argument("--type", default="A")

    q = cps.add_parser("volume")
    q.add_argument("verb", choices=["list", "adopt"])
    q.add_argument("--server")
    q.add_argument("--name")

    q = cps.add_parser("build")
    q.add_argument("verb", choices=["submit", "list", "show", "logs",
                                    "cancel"])
    q.add_argument("--repo")
    q.add_argument("--tag")
    q.add_argument("--ref", default="main")
    q.add_argument("--push", action="store_true")
    q.add_argument("name", nargs="?")

    q = cps.add_parser("placement")
    q.add_argument("verb", choices=["state", "explain"])
    q.add_argument("--stage", help="stage key <flow>/<stage> (explain)")
    q.add_argument("--service", help="service row name (explain)")

    q = cps.add_parser("remote")
    q.add_argument("verb", choices=["deploy", "history"])
    q.add_argument("--server")
    q.add_argument("--path", help="project path on the remote server")
    q.add_argument("--stage", dest="stage_name")
    q.add_argument("--project")
    q.add_argument("--tenant")
    q.add_argument("--ssh-user")
    q.add_argument("--limit", type=int, default=20)

    q = cps.add_parser("registry")
    q.add_argument("verb", choices=["list", "status", "solve", "sync",
                                    "deploy"])
    q.add_argument("name", nargs="?", help="fleet filter for deploy")
    q.add_argument("--stage", help="stage filter for deploy")
    q.add_argument("--dry-run", action="store_true")

    p.set_defaults(fn=cmd_cp)

    p = sub.add_parser("admit", help="streaming admission: queue depth, "
                       "tenant fairness, backpressure and autoscaler "
                       "pressure (docs/guide/14-streaming-admission.md)")
    p.add_argument("--cp", dest="cp", help="CP endpoint host:port")
    adms = p.add_subparsers(dest="admit_cmd", required=True)
    q = adms.add_parser("status", help="per-tenant queues, waits, "
                        "fairness debt, parked/shed counts, pressure")
    q.add_argument("--json", action="store_true",
                   help="raw deploy.admit_status payload")
    p.set_defaults(fn=cmd_admit)

    p = sub.add_parser("slo", help="rolling SLO engine: declared "
                       "objectives vs observed quantiles + burn rates "
                       "(docs/guide/10-observability.md)")
    p.add_argument("--cp", dest="cp", help="CP endpoint host:port")
    slos = p.add_subparsers(dest="slo_cmd", required=True)
    q = slos.add_parser("status", help="objectives vs observed rolling "
                        "quantiles, fast/slow burn rates, stream census")
    q.add_argument("--json", action="store_true",
                   help="raw health.slo.status payload")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser("top", help="live fleet-wide telemetry: CP deep "
                       "gauges + per-agent heartbeat-shipped series "
                       "(docs/guide/10-observability.md)")
    p.add_argument("--cp", dest="cp", help="CP endpoint host:port")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (scripting/CI)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="redraw cadence in seconds (default: 2)")
    p.add_argument("--window", type=float, default=60.0,
                   help="aggregate window in seconds (default: 60)")
    p.add_argument("--filter", help="only series whose name contains "
                   "this substring")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("obs", help="time-series store: windowed queries, "
                       "series census, OpenMetrics/JSONL export")
    p.add_argument("--cp", dest="cp", help="CP endpoint host:port")
    obss = p.add_subparsers(dest="obs_cmd", required=True)
    q = obss.add_parser("query", help="windowed aggregates per series "
                        "(count/min/max/mean/last, counter rate, "
                        "p50/p90/p99)")
    q.add_argument("--name", help="exact series name")
    q.add_argument("--label", action="append", metavar="K=V",
                   help="label subset filter (repeatable; e.g. "
                   "--label agent=node-1)")
    q.add_argument("--window", type=float, default=60.0,
                   help="window in seconds (default: 60)")
    q.add_argument("--json", action="store_true",
                   help="raw obs.query payload")
    q = obss.add_parser("series", help="list series names/labels/kinds "
                        "+ store stats")
    q.add_argument("--json", action="store_true",
                   help="raw obs.series payload")
    q = obss.add_parser("export", help="dump retained samples")
    q.add_argument("--format", choices=["openmetrics", "jsonl"],
                   default="openmetrics")
    q.add_argument("--output", "-o", help="write to this path instead "
                   "of stdout")
    p.set_defaults(fn=cmd_obs)

    p = sub.add_parser("chaos", help="seeded fault injection against a "
                       "simulated fleet (invariant-checked)")
    chs = p.add_subparsers(dest="chaos_cmd", required=True)
    q = chs.add_parser("run", help="replay a scenario's fault schedule")
    q.add_argument("--scenario", default="rolling-kill",
                   help="scenario name (see `fleet chaos list`)")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--services", type=int, default=200)
    q.add_argument("--nodes", type=int, default=20)
    q.add_argument("--stages", type=int, default=4)
    q.add_argument("--pool-min", type=int, default=2, dest="pool_min",
                   help="autoscaler worker-pool floor (0 = no pool)")
    q.add_argument("--json", help="write the full report (events, "
                   "violations, digest) to this path")
    q.add_argument("--tsdb-out", dest="tsdb_out",
                   help="write the scenario's TSDB capture (every series "
                   "sampled at reconcile boundaries, deterministic "
                   "schema + content digest) to this path")
    q.add_argument("--expect-digest", dest="expect_digest",
                   help="fail unless the event-log digest equals this "
                   "(CI pinning: same seed must replay byte-identically)")
    q.add_argument("--record-trace", dest="record_trace",
                   help="write the run's traffic trace (JSONL timeline "
                   "+ baseline SLOs) for `fleet plan simulate`")
    q.add_argument("--show-schedule", action="store_true",
                   help="print the expanded fault schedule and exit")
    q.add_argument("--host", action="store_true",
                   help="place with the host greedy placer instead of "
                        "the GPU solver")
    q.add_argument("--list", action="store_true",
                   help="list scenarios and exit")
    chs.add_parser("list", help="list canned scenarios")
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser("plan", help="capacity planning: replay recorded "
                       "traffic against a proposed flow")
    pls = p.add_subparsers(dest="plan_cmd", required=True)
    q = pls.add_parser("simulate", help="replay a recorded trace "
                       "against a proposed KDL flow and report SLO "
                       "deltas")
    q.add_argument("flow", help="path to the proposed flow KDL file")
    q.add_argument("--trace", required=True,
                   help="traffic trace from `fleet chaos run "
                   "--record-trace`")
    q.add_argument("--pool-min", type=int, default=None, dest="pool_min",
                   help="override the trace's worker-pool floor")
    q.add_argument("--json", help="write the full SLO-delta report to "
                   "this path")
    q.add_argument("--expect-digest", dest="expect_digest",
                   help="fail unless the report digest equals this "
                   "(CI pinning)")
    q.add_argument("--host", action="store_true",
                   help="place with the host greedy placer instead of "
                        "the GPU solver")
    p.set_defaults(fn=cmd_plan)
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FlowError, ControlPlaneError, SolverError, ValueError) as e:
        # FlowError covers config/runtime; ControlPlaneError covers RpcError
        # (unreachable CP); ValueError covers bad service/verb arguments
        print(f"error: {e}", file=sys.stderr)
        return 1
    except KeyError as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
