"""Image build/push drivers.

Analog of fleetflow-build builder.rs:23 / pusher.rs:41: run `docker build`
with resolved inputs (streaming output to a line callback the way the
reference streams Bollard build events) and `docker push` with auth
pre-flight. The subprocess runner is injectable so tests exercise argv
construction without docker.

The port's copy of ``fleetflow_tpu/build/builder.py``.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Optional

from ..core.errors import FlowError
from .auth import auth_for_registry, registry_for_image
from .resolver import ResolvedBuild

__all__ = ["ImageBuilder", "ImagePusher", "BuildFailed"]


class BuildFailed(FlowError):
    pass


def _default_runner(args: list[str],
                    on_line: Optional[Callable[[str], None]] = None
                    ) -> tuple[int, str]:
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        line = line.rstrip("\n")
        lines.append(line)
        if on_line:
            on_line(line)
    proc.wait()
    return proc.returncode, "\n".join(lines)


class ImageBuilder:
    def __init__(self, runner=None):
        self.runner = runner or _default_runner

    def build(self, resolved: ResolvedBuild,
              on_line: Optional[Callable[[str], None]] = None) -> str:
        """builder.rs build_image_from_path:23. Returns the tag."""
        args = ["docker", "build", "-t", resolved.tag,
                "-f", str(resolved.dockerfile)]
        for k, v in sorted(resolved.args.items()):
            args += ["--build-arg", f"{k}={v}"]
        if resolved.target:
            args += ["--target", resolved.target]
        if resolved.no_cache:
            args.append("--no-cache")
        args.append(str(resolved.context))
        rc, out = self.runner(args, on_line)
        if rc != 0:
            raise BuildFailed(f"docker build failed (rc={rc}):\n{out[-2000:]}")
        return resolved.tag


class ImagePusher:
    def __init__(self, runner=None):
        self.runner = runner or _default_runner

    def push(self, tag: str,
             on_line: Optional[Callable[[str], None]] = None) -> str:
        """pusher.rs push:41 with auth.rs pre-flight: surface a actionable
        error when no credentials exist for the target registry."""
        registry = registry_for_image(tag)
        auth = auth_for_registry(registry)
        if not auth.resolved:
            raise BuildFailed(
                f"no credentials for registry {registry!r} in docker config "
                "(run `docker login` first)")
        rc, out = self.runner(["docker", "push", tag], on_line)
        if rc != 0:
            raise BuildFailed(f"docker push failed (rc={rc}):\n{out[-2000:]}")
        return tag
