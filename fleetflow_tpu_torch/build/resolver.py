"""Build input resolution.

Analog of fleetflow-build resolver.rs:6-130: given a Service with a
`build{}` block and the project root, resolve the dockerfile path (explicit
-> context/Dockerfile), the context directory, merged build args (config +
FLEET_BUILD_* env), and the image tag (explicit image_tag -> image:version
-> service name:latest, with the stage registry prefixed when present).

The port's copy of ``fleetflow_tpu/build/resolver.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..core.errors import FlowError
from ..core.model import Service

__all__ = ["BuildResolver", "ResolvedBuild"]

ENV_ARG_PREFIX = "FLEET_BUILD_"


class BuildError(FlowError):
    pass


@dataclass
class ResolvedBuild:
    dockerfile: Path
    context: Path
    args: dict[str, str] = field(default_factory=dict)
    tag: str = ""
    target: Optional[str] = None
    no_cache: bool = False


class BuildResolver:
    def __init__(self, project_root: str = ".",
                 registry: Optional[str] = None,
                 env: Optional[dict[str, str]] = None):
        self.root = Path(project_root).resolve()
        self.registry = registry
        self.env = os.environ if env is None else env

    def resolve(self, svc: Service) -> ResolvedBuild:
        if svc.build is None:
            raise BuildError(f"service {svc.name!r} has no build{{}} config")
        b = svc.build
        context = self.resolve_context(b.context)
        return ResolvedBuild(
            dockerfile=self.resolve_dockerfile(b.dockerfile, context),
            context=context,
            args=self.resolve_build_args(b.args),
            tag=self.resolve_image_tag(svc),
            target=b.target,
            no_cache=b.no_cache,
        )

    def resolve_context(self, context: str) -> Path:
        """resolver.rs resolve_context:66."""
        p = (self.root / context).resolve()
        if not p.is_dir():
            raise BuildError(f"build context {p} does not exist")
        return p

    def resolve_dockerfile(self, dockerfile: Optional[str],
                           context: Path) -> Path:
        """resolver.rs resolve_dockerfile:23: explicit path (relative to
        project root) or context/Dockerfile."""
        if dockerfile:
            p = (self.root / dockerfile).resolve()
        else:
            p = context / "Dockerfile"
        if not p.is_file():
            raise BuildError(f"dockerfile {p} does not exist")
        return p

    def resolve_build_args(self, args: dict[str, str]) -> dict[str, str]:
        """resolver.rs resolve_build_args:93: config args + FLEET_BUILD_*
        env (env wins)."""
        out = dict(args)
        for k, v in self.env.items():
            if k.startswith(ENV_ARG_PREFIX):
                out[k[len(ENV_ARG_PREFIX):]] = v
        return out

    def resolve_image_tag(self, svc: Service) -> str:
        """resolver.rs resolve_image_tag:130."""
        if svc.build and svc.build.image_tag:
            tag = svc.build.image_tag
        else:
            tag = svc.image_name()
        # prefix the stage registry only when the tag has no registry host
        # already (first path component with '.'/':' = host, like
        # auth.registry_for_image)
        first = tag.split("/", 1)[0]
        has_registry = "/" in tag and ("." in first or ":" in first
                                       or first == "localhost")
        if self.registry and not has_registry:
            tag = f"{self.registry.rstrip('/')}/{tag}"
        return tag
