"""Secret reference resolution (1Password `op://` URIs).

Analog of crates/fleetflow-core/src/onepassword.rs: detect
``op://vault/item/field`` references in variable values and resolve them by
shelling out to the 1Password CLI (``op read``), batched. Gated: when the
``op`` binary is absent the references raise a clear error instead of
silently passing through.

The port's copy of ``fleetflow_tpu/core/secrets.py``.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

from .errors import FlowError

__all__ = ["is_op_reference", "resolve_reference", "resolve_op_references"]

_OP_PREFIX = "op://"


def is_op_reference(value: str) -> bool:
    """True for `op://vault/item/field[/...]` (reference: onepassword.rs:126)."""
    if not isinstance(value, str) or not value.startswith(_OP_PREFIX):
        return False
    parts = value[len(_OP_PREFIX):].split("/")
    return len(parts) >= 3 and all(parts[:3])


def _op_binary() -> Optional[str]:
    return shutil.which("op")


def resolve_reference(ref: str, timeout: float = 30.0) -> str:
    """Resolve one reference via `op read` (reference: onepassword.rs:152)."""
    if not is_op_reference(ref):
        raise FlowError(f"not an op:// reference: {ref!r}")
    op = _op_binary()
    if op is None:
        raise FlowError(
            f"variable references a 1Password secret ({ref!r}) but the `op` "
            "CLI is not installed")
    try:
        proc = subprocess.run([op, "read", ref], capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise FlowError(f"`op read {ref}` timed out") from None
    if proc.returncode != 0:
        raise FlowError(f"`op read {ref}` failed: {proc.stderr.strip()}")
    return proc.stdout.rstrip("\n")


def resolve_op_references(variables: dict[str, str]) -> dict[str, str]:
    """Batch-resolve every op:// value (reference: onepassword.rs:292)."""
    out = dict(variables)
    for k, v in variables.items():
        if isinstance(v, str) and is_op_reference(v):
            out[k] = resolve_reference(v)
    return out
