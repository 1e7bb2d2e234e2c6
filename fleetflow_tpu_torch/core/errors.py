"""Error types (the port's copy of ``fleetflow_tpu/core/errors.py``;
reference: crates/fleetflow-core/src/error.rs `FlowError`)."""

from __future__ import annotations

__all__ = ["FlowError", "ConfigNotFound", "ContainerError", "CloudError",
           "ControlPlaneError", "SolverError", "DeviceUnavailable",
           "KernelError", "AgentCommandError", "AgentUnreachable",
           "AgentCommandFailed"]


class FlowError(Exception):
    """Config-layer error (parse, template, discovery, load)."""


class ConfigNotFound(FlowError):
    """No .fleetflow/fleet.kdl found walking up from cwd."""


class ContainerError(Exception):
    """Execution-engine error (reference: fleetflow-container/src/error.rs)."""


class CloudError(Exception):
    """Cloud provider error."""


class ControlPlaneError(Exception):
    """Control-plane / wire-protocol error."""


class AgentCommandError(ControlPlaneError):
    """A command routed to a node agent failed.

    Subclasses split the one failure mode the registry used to report into
    the two a caller must treat differently: `retryable` says whether the
    SAME command may succeed later (dead/slow session, timeout) or the
    agent executed it and reported failure (redelivery would rerun a
    failing deploy, not fix it). `reason` is a short stable token for
    metrics/log labels — never string-match the message."""

    retryable: bool = False

    def __init__(self, message: str, *, reason: str = "error"):
        super().__init__(message)
        self.reason = reason


class AgentUnreachable(AgentCommandError):
    """Transport/liveness failure: the command may never have reached the
    agent (not connected, disconnected mid-command, timeout, delivery
    refused). Safe to retry — with an idempotency key, safe even when the
    agent DID receive it."""

    retryable = True

    def __init__(self, message: str, *, reason: str = "unreachable"):
        super().__init__(message, reason=reason)


class AgentCommandFailed(AgentCommandError):
    """The agent executed the command and reported an error. Retrying
    verbatim re-runs the same failure; callers should escalate (park,
    alert) instead."""

    retryable = False

    def __init__(self, message: str, *, reason: str = "agent-error"):
        super().__init__(message, reason=reason)


class SolverError(Exception):
    """Placement solver error (infeasible, bad tensors, missing device)."""


class DeviceUnavailable(SolverError):
    """The card a solve asked for is not there (no CUDA in the process).
    Not a solver failure the control plane may degrade around: placing on
    the host instead would hide the missing device."""


class KernelError(RuntimeError):
    """A hand-written kernel or host library could not be built or loaded,
    or a launch returned a CUDA error. Like DeviceUnavailable, a fault of
    the device path itself, never degraded around."""
