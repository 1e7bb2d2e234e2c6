"""Static-site service execution (ServiceType.STATIC).

The reference runs static services in two places: `fleet up` builds and
serves them through `wrangler pages dev` (fleetflow/src/commands/up.rs:
139-195), and `fleet deploy` builds and ships them through
`wrangler pages deploy` with a provider dispatch that today knows
"cloudflare-pages" (deploy.rs:265-352).  This module is the Python analog,
with injectable runners so the logic is testable without wrangler or a
shell (the reference pattern: pure functions + CLI shellouts at the edge).

The port's copy of ``fleetflow_tpu/runtime/static_site.py``.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from ..core.errors import CloudError, FlowError
from ..core.model import Service, ServiceType

__all__ = ["StaticDeployResult", "build_static", "deploy_static",
           "split_static_services", "up_static"]

# runner(argv, cwd) -> (returncode, combined_output)
Runner = Callable[[list[str], Optional[str]], tuple[int, str]]

# Pages projects already verified/created this process (deploy_static)
_ENSURED_PAGES_PROJECTS: set = set()


def _shell_runner(argv: list[str], cwd: Optional[str]) -> tuple[int, str]:
    proc = subprocess.run(argv, cwd=cwd, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def split_static_services(services: list[Service]):
    """(static, container) partition of a resolved service list: static
    services never reach the container engine (up.rs:139 runs them before
    the per-service docker loop)."""
    static = [s for s in services if s.service_type is ServiceType.STATIC]
    container = [s for s in services if s.service_type is not ServiceType.STATIC]
    return static, container


def _output_dir(svc: Service) -> str:
    if svc.deploy is not None and svc.deploy.output:
        return svc.deploy.output
    return "dist"  # reference default (up.rs:169)


def build_static(svc: Service, project_root: str,
                 runner: Optional[Runner] = None,
                 on_line: Optional[Callable[[str], None]] = None) -> None:
    """Run the service's build command (`sh -c`, cwd=project root), exactly
    the reference's build step (up.rs:154-166 / deploy.rs:294-306).  No
    command configured = nothing to build."""
    cmd = svc.command or (svc.deploy.command if svc.deploy else None)
    if not cmd:
        return
    run = runner or _shell_runner
    if on_line:
        on_line(f"build: {cmd}")
    rc, out = run(["sh", "-c", cmd], project_root)
    if rc != 0:
        raise FlowError(f"build command failed for {svc.name!r}: "
                        f"{cmd} (rc={rc}): {out[-500:]}")


def up_static(svc: Service, project_root: str,
              runner: Optional[Runner] = None,
              on_line: Optional[Callable[[str], None]] = None,
              port: int = 8788):
    """`fleet up` path: build, then start the Pages dev server.

    With a runner injected (tests) the dev server is invoked synchronously
    through it and None is returned; otherwise returns the Popen handle of
    the background `wrangler pages dev` so the CLI can wait on it
    (up.rs:174-194 waits in the foreground until Ctrl+C).
    """
    build_static(svc, project_root, runner=runner, on_line=on_line)
    out = str(Path(project_root) / _output_dir(svc))
    if on_line:
        on_line(f"dev server: wrangler pages dev {out}")
    if runner is not None:
        rc, text = runner(["wrangler", "pages", "dev", out,
                           "--port", str(port)], project_root)
        if rc != 0:
            raise FlowError(f"wrangler pages dev failed for {svc.name!r}: "
                            f"{text[-500:]}")
        return None
    from ..cloud.cloudflare import wrangler_pages_dev
    return wrangler_pages_dev(out, port=port, cwd=project_root)


@dataclass
class StaticDeployResult:
    service: str
    project: str
    url: Optional[str]


def deploy_static(svc: Service, project_root: str,
                  runner: Optional[Runner] = None,
                  on_line: Optional[Callable[[str], None]] = None
                  ) -> StaticDeployResult:
    """`fleet deploy` path: build, then dispatch on deploy.type.

    Mirrors deploy.rs:265-352: cloudflare-pages is the one supported
    provider; anything else is an explicit error, and a missing deploy
    config/project is an error (the reference bails on each)."""
    if svc.deploy is None:
        raise FlowError(f"service {svc.name!r} has no deploy{{}} config")
    provider = svc.deploy.type or "cloudflare-pages"
    if provider != "cloudflare-pages":
        raise FlowError(f"unsupported static deploy provider {provider!r} "
                        f"(supported: cloudflare-pages)")
    if not svc.deploy.project:
        raise FlowError(f"service {svc.name!r}: deploy.project is required "
                        f"for cloudflare-pages")

    build_static(svc, project_root, runner=runner, on_line=on_line)
    out = str(Path(project_root) / _output_dir(svc))
    if on_line:
        on_line(f"deploy: {out} -> Cloudflare Pages "
                f"({svc.deploy.project})")
    from ..cloud.cloudflare import (ensure_pages_project,
                                    wrangler_pages_deploy)

    def _cf_runner(argv: list[str]) -> tuple[int, str]:
        # adapt our (argv, cwd) runner shape to the cloudflare module's
        return runner(argv, project_root)

    cf_runner = _cf_runner if runner else None
    # first deploy of a fresh project: create it rather than fail
    # (wrangler errors when the Pages project doesn't exist yet). Best
    # effort — a listing/create failure falls through to the deploy,
    # whose own error is authoritative — and cached per process so
    # repeat deploys don't pay the listing roundtrip every time.
    if svc.deploy.project not in _ENSURED_PAGES_PROJECTS:
        try:
            if ensure_pages_project(svc.deploy.project, runner=cf_runner):
                if on_line:
                    on_line(f"created Pages project {svc.deploy.project}")
            _ENSURED_PAGES_PROJECTS.add(svc.deploy.project)
        except CloudError:
            pass
    text = wrangler_pages_deploy(out, svc.deploy.project,
                                 cwd=project_root,
                                 runner=cf_runner)
    url = None
    for tok in text.split():
        if tok.startswith("https://") and ".pages.dev" in tok:
            url = tok.strip().rstrip(".,;")
            break
    return StaticDeployResult(service=svc.name, project=svc.deploy.project,
                              url=url)
