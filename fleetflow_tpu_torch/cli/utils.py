"""CLI helpers.

Analog of fleetflow utils.rs:4-174: stage-name defaulting (positional >
-s flag > FLEET_STAGE env > "local"), service filtering, sensitive-key
masking for plan printers, duration parsing, and shell quoting.
"""

from __future__ import annotations

import os
import re
import shlex
from typing import Optional

__all__ = ["determine_stage_name", "filter_services", "mask_sensitive",
           "mask_env", "parse_duration", "shell_quote"]

STAGE_ENV = "FLEET_STAGE"
DEFAULT_STAGE = "local"

# utils.rs:76 sensitive-key detection
_SENSITIVE = re.compile(
    r"(password|passwd|secret|token|api[-_]?key|private[-_]?key|credential"
    r"|auth)", re.IGNORECASE)


def determine_stage_name(positional: Optional[str] = None,
                         flag: Optional[str] = None,
                         env: Optional[dict] = None) -> str:
    """utils.rs:4 + main.rs:40-47 precedence."""
    env = os.environ if env is None else env
    return positional or flag or env.get(STAGE_ENV) or DEFAULT_STAGE


def filter_services(names: list[str], wanted: list[str]) -> list[str]:
    """utils.rs:46: keep declared order; unknown requests are errors."""
    if not wanted:
        return list(names)
    unknown = [w for w in wanted if w not in names]
    if unknown:
        raise ValueError(f"unknown services {unknown}; "
                         f"defined: {names}")
    return [n for n in names if n in wanted]


def mask_sensitive(key: str, value: str) -> str:
    """utils.rs:76: mask values of sensitive-looking keys in plan output."""
    if not _SENSITIVE.search(key):
        return value
    if len(value) <= 4:
        return "****"
    return value[:2] + "*" * min(len(value) - 4, 8) + value[-2:]


def mask_env(env: dict[str, str]) -> dict[str, str]:
    return {k: mask_sensitive(k, v) for k, v in env.items()}


_DURATION = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)?$")


def parse_duration(s: str) -> float:
    """utils.rs:135: '30s', '5m', '2h', '500ms' -> seconds."""
    m = _DURATION.match(s.strip())
    if not m:
        raise ValueError(f"invalid duration {s!r} (expected e.g. 30s, 5m, 2h)")
    value, unit = float(m.group(1)), m.group(2) or "s"
    return value * {"ms": 1e-3, "s": 1, "m": 60, "h": 3600, "d": 86400}[unit]


def shell_quote(args: list[str]) -> str:
    """utils.rs:174."""
    return " ".join(shlex.quote(a) for a in args)
