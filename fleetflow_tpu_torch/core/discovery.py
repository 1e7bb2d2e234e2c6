"""Convention-based config file discovery.

Analog of crates/fleetflow-core/src/discovery.rs: walk up from cwd to find
the project root (a directory containing ``.fleetflow/fleet.kdl``, or the
``FLEET_PROJECT_ROOT`` env override), then scan ``.fleetflow/`` for the
conventional file set — ``cloud.kdl``, ``fleet.kdl``, ``services/*.kdl``,
``stages/*.kdl``, ``variables/*.kdl``, ``flow.{stage}.kdl``,
``flow.local.kdl`` — recursively, alpha-sorted, with a symlink-loop guard
(discovery.rs:89-202).

The port's copy of ``fleetflow_tpu/core/discovery.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from .errors import ConfigNotFound

__all__ = ["DiscoveredFiles", "find_project_root", "discover_files_with_stage",
           "CONFIG_DIR_NAME", "MAIN_FILE_NAME"]

CONFIG_DIR_NAME = ".fleetflow"
MAIN_FILE_NAME = "fleet.kdl"


@dataclass
class DiscoveredFiles:
    """The conventional file set (reference: discovery.rs:12-34)."""
    root: str
    config_dir: str
    cloud_file: Optional[str] = None
    main_file: Optional[str] = None
    service_files: list[str] = field(default_factory=list)
    stage_files: list[str] = field(default_factory=list)
    variable_files: list[str] = field(default_factory=list)
    stage_override_file: Optional[str] = None   # flow.{stage}.kdl
    local_override_file: Optional[str] = None   # flow.local.kdl

    def all_files(self) -> list[str]:
        """Fixed concatenation order (reference: loader.rs:137-209):
        cloud, fleet, services/, stages/, flow.{stage}, flow.local."""
        out: list[str] = []
        if self.cloud_file:
            out.append(self.cloud_file)
        if self.main_file:
            out.append(self.main_file)
        out.extend(self.service_files)
        out.extend(self.stage_files)
        if self.stage_override_file:
            out.append(self.stage_override_file)
        if self.local_override_file:
            out.append(self.local_override_file)
        return out


def find_project_root(start: Optional[str] = None) -> str:
    """Walk up from `start` (default cwd) looking for `.fleetflow/fleet.kdl`;
    `FLEET_PROJECT_ROOT` env wins (reference: discovery.rs:44)."""
    env_root = os.environ.get("FLEET_PROJECT_ROOT")
    if env_root:
        if os.path.isfile(os.path.join(env_root, CONFIG_DIR_NAME, MAIN_FILE_NAME)):
            return os.path.realpath(env_root)
        raise ConfigNotFound(
            f"FLEET_PROJECT_ROOT={env_root!r} has no {CONFIG_DIR_NAME}/{MAIN_FILE_NAME}")
    cur = os.path.realpath(start or os.getcwd())
    while True:
        if os.path.isfile(os.path.join(cur, CONFIG_DIR_NAME, MAIN_FILE_NAME)):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            raise ConfigNotFound(
                f"no {CONFIG_DIR_NAME}/{MAIN_FILE_NAME} found walking up from "
                f"{start or os.getcwd()}")
        cur = parent


def _scan_kdl(directory: str) -> list[str]:
    """Recursive `*.kdl` scan, alpha-sorted, symlink-loop-guarded
    (reference: discovery.rs recursive scan)."""
    results: list[str] = []
    seen_dirs: set[str] = set()

    def walk(d: str) -> None:
        real = os.path.realpath(d)
        if real in seen_dirs:
            return
        seen_dirs.add(real)
        try:
            entries = sorted(os.listdir(d))
        except OSError:
            return
        for name in entries:
            p = os.path.join(d, name)
            if os.path.isdir(p):
                walk(p)
            elif name.endswith(".kdl"):
                results.append(p)

    walk(directory)
    return sorted(results)


def discover_files_with_stage(root: Optional[str] = None,
                              stage: Optional[str] = None) -> DiscoveredFiles:
    """Discover the conventional file set under `{root}/.fleetflow/`
    (reference: discovery.rs:89-202)."""
    root = root or find_project_root()
    config_dir = os.path.join(root, CONFIG_DIR_NAME)
    d = DiscoveredFiles(root=root, config_dir=config_dir)
    if not os.path.isdir(config_dir):
        raise ConfigNotFound(f"{config_dir} is not a directory")

    cloud = os.path.join(config_dir, "cloud.kdl")
    if os.path.isfile(cloud):
        d.cloud_file = cloud
    main = os.path.join(config_dir, MAIN_FILE_NAME)
    if os.path.isfile(main):
        d.main_file = main

    services_dir = os.path.join(config_dir, "services")
    if os.path.isdir(services_dir):
        d.service_files = _scan_kdl(services_dir)
    stages_dir = os.path.join(config_dir, "stages")
    if os.path.isdir(stages_dir):
        d.stage_files = _scan_kdl(stages_dir)
    variables_dir = os.path.join(config_dir, "variables")
    if os.path.isdir(variables_dir):
        d.variable_files = _scan_kdl(variables_dir)

    if stage:
        p = os.path.join(config_dir, f"flow.{stage}.kdl")
        if os.path.isfile(p):
            d.stage_override_file = p
    local = os.path.join(config_dir, "flow.local.kdl")
    if os.path.isfile(local):
        d.local_override_file = local
    return d
