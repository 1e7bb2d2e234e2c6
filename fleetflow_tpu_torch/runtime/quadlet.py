"""Podman Quadlet backend: systemd unit generation.

Analog of fleetflow-container quadlet.rs: pure generators that turn a stage
into systemd `.container` / `.network` units (deps -> After=/Requires=,
quadlet.rs:92-99; restart mapping :44; HealthCmd :57), plus the sync logic
that only touches unit files carrying our ownership marker (:229,250) and
the `systemctl --user` orchestration (:288-299,400).

Generators are pure and tested without systemd, like the reference's.

The port's copy of ``fleetflow_tpu/runtime/quadlet.py``.
"""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..core.model import Flow, RestartPolicy, Service, ServiceType, Stage
from .converter import container_name, network_name

__all__ = ["generate_container_unit", "generate_network_unit",
           "build_stage_units", "sync_units", "apply_stage", "down_stage",
           "QuadletApplyOutcome", "OWNERSHIP_MARKER"]

OWNERSHIP_MARKER = "# Managed by fleetflow-tpu; do not edit."

_RESTART_MAP = {
    RestartPolicy.NO: "no",
    RestartPolicy.ALWAYS: "always",
    RestartPolicy.ON_FAILURE: "on-failure",
    RestartPolicy.UNLESS_STOPPED: "always",  # systemd has no unless-stopped
}


def _unit_name(project: str, stage: str, service: str) -> str:
    return f"{container_name(project, stage, service)}.container"


def _network_unit_name(project: str, stage: str) -> str:
    return f"{network_name(project, stage)}.network"


def generate_network_unit(project: str, stage: str) -> str:
    """A .network Quadlet unit for the stage network (quadlet.rs network
    unit generation)."""
    net = network_name(project, stage)
    return "\n".join([
        OWNERSHIP_MARKER,
        _scope_line(project, stage),
        "[Unit]",
        f"Description=fleetflow network {net}",
        "",
        "[Network]",
        f"NetworkName={net}",
        "",
        "[Install]",
        "WantedBy=default.target",
        "",
    ])


def generate_container_unit(svc: Service, project: str, stage: str) -> str:
    """A .container Quadlet unit for one service (quadlet.rs:76-120).

    Dependencies become systemd ordering: After=/Requires= on the dep's
    service unit (quadlet.rs:92-99), which delegates the reference's waiter
    loop to systemd's dependency engine.
    """
    net_unit = _network_unit_name(project, stage)
    lines = [OWNERSHIP_MARKER, _scope_line(project, stage), "[Unit]",
             f"Description=fleetflow service {svc.name} ({project}/{stage})"]
    for dep in svc.depends_on:
        dep_unit = f"{container_name(project, stage, dep)}.service"
        lines.append(f"After={dep_unit}")
        lines.append(f"Requires={dep_unit}")
    lines += ["", "[Container]",
              f"ContainerName={container_name(project, stage, svc.name)}",
              f"Image={svc.image_name()}"]
    for p in svc.ports:
        host_ip = f"{p.host_ip}:" if p.host_ip else ""
        lines.append(f"PublishPort={host_ip}{p.host}:{p.container}"
                     + ("/udp" if p.protocol.value == "udp" else ""))
    for v in svc.volumes:
        suffix = ":ro" if v.read_only else ""
        lines.append(f"Volume={v.host}:{v.container}{suffix}")
    for k, val in sorted(svc.environment.items()):
        lines.append(f"Environment={k}={val}")
    lines.append(f"Network={net_unit}")
    for k, val in sorted({"fleetflow.project": project,
                          "fleetflow.stage": stage,
                          "fleetflow.service": svc.name,
                          **svc.labels}.items()):
        lines.append(f"Label={k}={val}")
    if svc.healthcheck and svc.healthcheck.test:
        hc = svc.healthcheck
        test = hc.test
        cmd = " ".join(test[1:] if test[0] in ("CMD", "CMD-SHELL") else test)
        lines.append(f"HealthCmd={cmd}")
        lines.append(f"HealthInterval={int(hc.interval)}s")
        lines.append(f"HealthTimeout={int(hc.timeout)}s")
        lines.append(f"HealthRetries={hc.retries}")
        lines.append(f"HealthStartPeriod={int(hc.start_period)}s")
    if svc.command:
        lines.append(f"Exec={svc.command}")
    lines += ["", "[Service]"]
    if svc.restart is not None:
        lines.append(f"Restart={_RESTART_MAP[svc.restart]}")
    else:
        lines.append("Restart=always")
    lines += ["", "[Install]", "WantedBy=default.target", ""]
    return "\n".join(lines)


def build_stage_units(flow: Flow, stage: Stage) -> dict[str, str]:
    """filename -> unit text for a whole stage (quadlet.rs:326)."""
    units = {_network_unit_name(flow.name, stage.name):
             generate_network_unit(flow.name, stage.name)}
    for svc in stage.resolved_services(flow):
        if svc.service_type is ServiceType.STATIC:
            continue  # static sites ship via wrangler, not systemd units
        units[_unit_name(flow.name, stage.name, svc.name)] = \
            generate_container_unit(svc, flow.name, stage.name)
    return units


def _scope_line(project: str, stage: str) -> str:
    """Second header line embedding the exact owner; the authoritative
    ownership test, immune to the name-prefix ambiguity of a stage
    called 'live' vs a sibling 'live-blue' (both hyphen-join into unit
    names where prefix matching cannot tell them apart)."""
    return f"# fleetflow-scope: {project}/{stage}"


@dataclass(frozen=True)
class StageScope:
    """Which unit files belong to one project/stage
    (quadlet.rs is_fleetflow_unit:229 with exact-owner precision)."""
    project: str
    stage: str

    def owns(self, name: str, header: list[str]) -> bool:
        if not header or header[0] != OWNERSHIP_MARKER:
            return False
        # scope line is authoritative when present; older files without
        # one fall back to the name test (exact network unit name or
        # separator-terminated service prefix — still ambiguous for
        # hyphenated sibling stages, which is why the scope line exists)
        if len(header) > 1 and header[1].startswith("# fleetflow-scope:"):
            return header[1] == _scope_line(self.project, self.stage)
        return (name == _network_unit_name(self.project, self.stage)
                or name.startswith(f"{network_name(self.project, self.stage)}-"))


def _stage_scope(project: str, stage: str) -> StageScope:
    return StageScope(project, stage)


def _remove_owned(d: Path, scope: StageScope,
                  keep: frozenset = frozenset()) -> list[str]:
    """Delete every unit file owned by `scope` except `keep`; shared by
    sync_units (stale cleanup) and down_stage --remove so the ownership
    test can never diverge between the two paths."""
    removed = []
    if not d.is_dir():
        return removed
    for f in d.iterdir():
        if f.suffix not in (".container", ".network") or f.name in keep:
            continue
        try:
            header = f.read_text().splitlines()[:2]
        except OSError:
            continue
        if scope.owns(f.name, header):
            f.unlink()
            removed.append(f.name)
    return removed


def sync_units(units: dict[str, str], unit_dir: str, *,
               scope: StageScope) -> tuple[list[str], list[str]]:
    """Write units into `unit_dir`; remove stale fleetflow-owned units of
    the SAME project/stage that are not in the new bundle. Never touches
    files without the ownership marker, and never another stage's files
    (quadlet.rs:229-250). Returns (written, removed)."""
    d = Path(unit_dir)
    d.mkdir(parents=True, exist_ok=True)
    removed = _remove_owned(d, scope, keep=frozenset(units))
    written = []
    for name, text in units.items():
        target = d / name
        if not target.exists() or target.read_text() != text:
            target.write_text(text)
            written.append(name)
    return written, removed


@dataclass
class QuadletApplyOutcome:
    """quadlet.rs:383."""
    written: list[str] = field(default_factory=list)
    removed: list[str] = field(default_factory=list)
    started: list[str] = field(default_factory=list)
    stopped: list[str] = field(default_factory=list)
    errors: dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors


def default_unit_dir() -> str:
    return os.path.expanduser("~/.config/containers/systemd")


def _default_systemctl(args: list[str]) -> tuple[int, str]:
    proc = subprocess.run(["systemctl", "--user", *args],
                          capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


# stop-failure outputs that mean "already down" — idempotent, not an error
_ALREADY_DOWN = ("not loaded", "not found", "does not exist", "not-found")


def down_stage(flow: Flow, stage_name: str, *, remove: bool = False,
               unit_dir: Optional[str] = None,
               systemctl=None) -> QuadletApplyOutcome:
    """`fleet down` on the quadlet backend (commands/quadlet.rs down:71):
    stop every service unit + the stage's network service; with `remove`,
    delete this project/stage's fleetflow-owned unit files and
    daemon-reload so the generated .service units disappear. Idempotent:
    stopping an already-gone unit is success, and removal is SKIPPED when
    any real stop failed (deleting the definition of a still-running
    container would orphan it from both systemd and `fleet up`)."""
    stage = flow.stage(stage_name)
    if systemctl is None:
        systemctl = _default_systemctl
    outcome = QuadletApplyOutcome()
    net = network_name(flow.name, stage_name)
    units = [f"{container_name(flow.name, stage_name, svc.name)}.service"
             for svc in stage.resolved_services(flow)
             if svc.service_type is not ServiceType.STATIC]
    # quadlet generates <name>-network.service from the .network file;
    # leaving it running would orphan the podman network after --remove
    units.append(f"{net}-network.service")
    for unit in units:
        rc, out = systemctl(["stop", unit])
        if rc == 0 or any(m in out.lower() for m in _ALREADY_DOWN):
            outcome.stopped.append(unit)
        else:
            outcome.errors[unit] = out
    if remove:
        if outcome.errors:
            outcome.errors["remove"] = \
                "skipped: stop failures above (a running container must " \
                "not lose its unit definition)"
            return outcome
        outcome.removed = _remove_owned(
            Path(unit_dir or default_unit_dir()),
            _stage_scope(flow.name, stage_name))
        rc, out = systemctl(["daemon-reload"])
        if rc != 0:
            outcome.errors["daemon-reload"] = out
    return outcome


def apply_stage(flow: Flow, stage_name: str, *,
                unit_dir: Optional[str] = None,
                systemctl=None) -> QuadletApplyOutcome:
    """Generate units, sync to disk, daemon-reload, start
    (quadlet.rs apply_stage:400). `systemctl` is an injectable callable
    (args: list[str]) -> (rc, output) for tests."""
    stage = flow.stage(stage_name)
    units = build_stage_units(flow, stage)
    outcome = QuadletApplyOutcome()
    outcome.written, outcome.removed = sync_units(
        units, unit_dir or default_unit_dir(),
        scope=_stage_scope(flow.name, stage_name))

    if systemctl is None:
        systemctl = _default_systemctl

    rc, out = systemctl(["daemon-reload"])
    if rc != 0:
        outcome.errors["daemon-reload"] = out
        return outcome
    for name in units:
        if not name.endswith(".container"):
            continue
        unit = name[: -len(".container")] + ".service"
        rc, out = systemctl(["start", unit])
        if rc == 0:
            outcome.started.append(unit)
        else:
            outcome.errors[unit] = out
    return outcome
