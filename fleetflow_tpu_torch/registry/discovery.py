"""Registry discovery: walk-up search for fleet-registry.kdl.

Analog of fleetflow-registry discovery.rs:24: starting at `start`, walk
parent directories looking for `fleet-registry.kdl` (also under
`.fleetflow/`), stopping at the filesystem root; `FLEET_REGISTRY` env
overrides.

The port's copy of ``fleetflow_tpu/registry/discovery.py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["find_registry", "REGISTRY_FILENAME"]

REGISTRY_FILENAME = "fleet-registry.kdl"
ENV_OVERRIDE = "FLEET_REGISTRY"


def find_registry(start: Optional[str] = None) -> Optional[Path]:
    env = os.environ.get(ENV_OVERRIDE)
    if env:
        p = Path(os.path.expanduser(env))
        return p if p.is_file() else None
    cur = Path(start or os.getcwd()).resolve()
    while True:
        for candidate in (cur / REGISTRY_FILENAME,
                          cur / ".fleetflow" / REGISTRY_FILENAME):
            if candidate.is_file():
                return candidate
        if cur.parent == cur:
            return None
        cur = cur.parent
