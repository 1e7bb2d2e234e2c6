"""Command hardening for agent-side execution.

Analog of fleet-agent deploy.rs security posture: compose-command
allowlisting with a flag denylist (:25-50), deploy-path confinement under
the agent's deploy base (:50), and container-name validation against shell
injection (:188). Pure functions, exhaustively testable.

The port's copy of ``fleetflow_tpu/agent/guard.py``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

from ..core.errors import FlowError

__all__ = ["GuardError", "validate_compose_command", "confine_path",
           "validate_container_name"]


class GuardError(FlowError):
    pass


# compose subcommands an agent will run on behalf of the CP
_ALLOWED_COMPOSE = {"up", "down", "ps", "pull", "restart", "logs", "config"}
# flags that would escape the sandboxed project scope
_DENIED_FLAGS = {"--file", "-f", "--project-directory", "--env-file", "-H",
                 "--host", "--context", "-c"}

_CONTAINER_NAME_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9_.-]{0,127}$")


def validate_compose_command(args: list[str]) -> list[str]:
    """Only `docker compose <allowed-subcommand>` survives; flags that
    redirect file/host/context are rejected (deploy.rs:25-50). Returns the
    validated argv tail (after `docker compose`)."""
    if not args:
        raise GuardError("empty compose command")
    sub = args[0]
    if sub not in _ALLOWED_COMPOSE:
        raise GuardError(f"compose subcommand {sub!r} not allowed "
                         f"(allowed: {sorted(_ALLOWED_COMPOSE)})")
    for a in args[1:]:
        flag = a.split("=", 1)[0]
        if flag in _DENIED_FLAGS:
            raise GuardError(f"compose flag {flag!r} not allowed")
        if a.startswith("-") and not re.fullmatch(r"-{1,2}[a-zA-Z0-9-]+(=.*)?", a):
            raise GuardError(f"malformed flag {a!r}")
    return args


def confine_path(path: str, base: str) -> Path:
    """Resolve `path` and require it stays under `base` (deploy.rs:50).
    Symlink escapes are caught by resolving both sides."""
    base_r = Path(base).resolve()
    p = (base_r / path).resolve() if not os.path.isabs(path) else Path(path).resolve()
    try:
        p.relative_to(base_r)
    except ValueError:
        raise GuardError(f"path {path!r} escapes deploy base {base!r}") from None
    return p


def validate_container_name(name: str) -> str:
    """Docker name charset only — nothing shell-significant survives
    (deploy.rs:188)."""
    if not _CONTAINER_NAME_RE.fullmatch(name):
        raise GuardError(f"invalid container name {name!r}")
    return name
