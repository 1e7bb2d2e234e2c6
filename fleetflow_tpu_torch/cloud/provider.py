"""Provider traits + registry (the port's copy of
``fleetflow_tpu/cloud/provider.py``).

Analog of fleetflow-cloud provider.rs:15-39 (`CloudProvider`: declarative
plan/apply over a provider's whole resource set) and
server_provider.rs:18-39 (`ServerProvider`: imperative server CRUD +
power). Providers register by name; lookup is the enum-dispatch analog of
the reference's ServerProviderKind.
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..core.errors import CloudError
from ..core.model import CloudProviderDecl, ServerResource
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from .action import ApplyResult, Plan
from .state import ProviderState

__all__ = ["CloudProvider", "ServerProvider", "ServerInfo",
           "register_provider", "get_provider", "provider_names",
           "note_degraded"]

log = get_logger("cloud.provider")

# metric catalog: docs/guide/10-observability.md. A provider that answers
# with an EMPTY result because it is misconfigured (no credentials, CLI
# missing, unparseable output) must be visible as degradation, not read
# as "no resources" (cloudflare worker_list, tailscale get_peers).
_M_DEGRADED = REGISTRY.counter(
    "fleet_cloud_provider_degraded_total",
    "Cloud provider calls that degraded to an empty result because the "
    "provider is misconfigured or unreachable, by provider",
    labels=("provider",))
_degraded_logged: set[tuple[str, str]] = set()
_degraded_lock = threading.Lock()


def note_degraded(provider: str, reason: str) -> None:
    """Count a degraded-to-empty provider answer and log a structured
    warning ONCE per (provider, reason) — visible without flooding the
    log on every poll."""
    _M_DEGRADED.inc(provider=provider)
    with _degraded_lock:
        if (provider, reason) in _degraded_logged:
            return
        _degraded_logged.add((provider, reason))
    log.warning("cloud provider degraded to empty result %s",
                kv(provider=provider, reason=reason))


@dataclass
class ServerInfo:
    """server_provider.rs server record."""
    id: str
    name: str
    status: str = "unknown"         # up|down|unknown
    ip: Optional[str] = None
    plan: Optional[str] = None
    zone: Optional[str] = None
    tags: list[str] = field(default_factory=list)


class CloudProvider(abc.ABC):
    """provider.rs:15-39."""

    name: str = "abstract"

    @abc.abstractmethod
    def check_auth(self) -> bool:
        """Credentials/CLI availability probe."""

    @abc.abstractmethod
    def get_state(self) -> ProviderState:
        """Observe current provider-side resources."""

    @abc.abstractmethod
    def plan(self, decl: CloudProviderDecl,
             servers: list[ServerResource]) -> Plan:
        """Diff desired config against observed state."""

    @abc.abstractmethod
    def apply(self, plan: Plan) -> ApplyResult:
        """Execute a plan."""

    def destroy(self, decl: CloudProviderDecl) -> ApplyResult:
        """Tear down everything this provider manages (provider.rs
        destroy). Default: apply the deletion plan for current state."""
        raise CloudError(f"provider {self.name!r} does not support destroy")


class ServerProvider(abc.ABC):
    """server_provider.rs:18-39."""

    name: str = "abstract"

    @abc.abstractmethod
    def list_servers(self) -> list[ServerInfo]: ...

    @abc.abstractmethod
    def get_server(self, server_id: str) -> Optional[ServerInfo]: ...

    @abc.abstractmethod
    def create_server(self, spec: ServerResource) -> ServerInfo: ...

    @abc.abstractmethod
    def delete_server(self, server_id: str) -> bool: ...

    @abc.abstractmethod
    def power_on(self, server_id: str) -> bool: ...

    @abc.abstractmethod
    def power_off(self, server_id: str) -> bool: ...


_REGISTRY: dict[str, type] = {}


def register_provider(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def get_provider(name: str, **kwargs):
    """ServerProviderKind dispatch."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise CloudError(
            f"unknown cloud provider {name!r}; "
            f"registered: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


def provider_names() -> list[str]:
    return sorted(_REGISTRY)
