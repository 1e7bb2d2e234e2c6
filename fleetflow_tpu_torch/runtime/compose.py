"""Compose backend: emit Compose Spec YAML from a Flow stage.

Analog of fleetflow-container compose.rs:72-254: a pure generator (careful
manual YAML escaping, compose.rs:36-55 — no yaml lib dependency means the
output is deterministic and injection-safe), a writer that lands the file at
`.fleetflow/compose.{stage}.yaml` (:210-217), and `docker compose` CLI
up/down shellouts (:254-269).

The port's copy of ``fleetflow_tpu/runtime/compose.py``.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

from ..core.model import Flow, ServiceType, Stage

__all__ = ["generate_compose_yaml", "write_compose_file",
           "compose_up", "compose_down"]


def _yaml_escape(s: str) -> str:
    """Quote when YAML would reinterpret the scalar (compose.rs:36-55)."""
    if s == "":
        return '""'
    needs_quote = (
        s != s.strip()
        or any(c in s for c in ":#{}[]&*!|>%@`\"'\\,\n")
        or s.lower() in ("true", "false", "null", "yes", "no", "on", "off", "~")
        or s[0] in "-?:"
        or _is_number(s)
    )
    if needs_quote:
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    return s


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def generate_compose_yaml(flow: Flow, stage: Stage) -> str:
    """Pure Flow-stage -> Compose Spec text (compose.rs:72-209)."""
    net = f"{flow.name}-{stage.name}"
    lines = [f"name: {_yaml_escape(net)}", "services:"]
    for svc in stage.resolved_services(flow):
        if svc.service_type is ServiceType.STATIC:
            continue  # static sites ship via wrangler, not compose
        lines.append(f"  {svc.name}:")
        lines.append(f"    image: {_yaml_escape(svc.image_name())}")
        lines.append(f"    container_name: {_yaml_escape(f'{flow.name}-{stage.name}-{svc.name}')}")
        if svc.command:
            lines.append(f"    command: {_yaml_escape(svc.command)}")
        if svc.restart is not None:
            lines.append(f"    restart: {_yaml_escape(svc.restart.value)}")
        if svc.ports:
            lines.append("    ports:")
            for p in svc.ports:
                host_ip = f"{p.host_ip}:" if p.host_ip else ""
                proto = "/udp" if p.protocol.value == "udp" else ""
                lines.append(f'      - "{host_ip}{p.host}:{p.container}{proto}"')
        if svc.volumes:
            lines.append("    volumes:")
            for v in svc.volumes:
                ro = ":ro" if v.read_only else ""
                lines.append(f"      - {_yaml_escape(f'{v.host}:{v.container}{ro}')}")
        if svc.environment:
            lines.append("    environment:")
            for k, val in sorted(svc.environment.items()):
                lines.append(f"      {k}: {_yaml_escape(val)}")
        if svc.depends_on:
            lines.append("    depends_on:")
            for dep in svc.depends_on:
                lines.append(f"      {dep}:")
                dep_svc = flow.services.get(dep)
                cond = ("service_healthy"
                        if dep_svc and dep_svc.healthcheck and dep_svc.healthcheck.test
                        else "service_started")
                lines.append(f"        condition: {cond}")
        if svc.healthcheck and svc.healthcheck.test:
            hc = svc.healthcheck
            lines.append("    healthcheck:")
            test = hc.test
            if test[0] not in ("CMD", "CMD-SHELL", "NONE"):
                test = ["CMD-SHELL", " ".join(test)]
            items = ", ".join(_yaml_escape(t) for t in test)
            lines.append(f"      test: [{items}]")
            lines.append(f"      interval: {int(hc.interval)}s")
            lines.append(f"      timeout: {int(hc.timeout)}s")
            lines.append(f"      retries: {hc.retries}")
            lines.append(f"      start_period: {int(hc.start_period)}s")
        # attribution labels ride every backend (converter.rs:128-139):
        # the agent monitor's inventory report keys on them, so compose-
        # deployed containers must carry them too
        labels = {"fleetflow.project": flow.name,
                  "fleetflow.stage": stage.name,
                  "fleetflow.service": svc.name, **svc.labels}
        lines.append("    labels:")
        for k, val in sorted(labels.items()):
            lines.append(f"      {k}: {_yaml_escape(val)}")
        lines.append("    networks:")
        lines.append("      default:")
        lines.append("        aliases:")
        lines.append(f"          - {_yaml_escape(svc.name)}")
    lines += ["networks:", "  default:", f"    name: {_yaml_escape(net)}", ""]
    return "\n".join(lines)


def write_compose_file(flow: Flow, stage_name: str,
                       project_root: str = ".") -> Path:
    """Write to .fleetflow/compose.{stage}.yaml (compose.rs:210-217)."""
    stage = flow.stage(stage_name)
    out = Path(project_root) / ".fleetflow" / f"compose.{stage_name}.yaml"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(generate_compose_yaml(flow, stage))
    return out


def _compose_cmd(path: Path, *args: str,
                 runner=None) -> tuple[int, str]:
    if runner is not None:
        return runner(["docker", "compose", "-f", str(path), *args])
    proc = subprocess.run(["docker", "compose", "-f", str(path), *args],
                          capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def compose_up(flow: Flow, stage_name: str, project_root: str = ".",
               runner=None) -> tuple[int, str]:
    """compose.rs:254."""
    path = write_compose_file(flow, stage_name, project_root)
    return _compose_cmd(path, "up", "-d", "--remove-orphans", runner=runner)


def compose_down(flow: Flow, stage_name: str, project_root: str = ".",
                 runner=None) -> tuple[int, str]:
    """compose.rs:269."""
    path = write_compose_file(flow, stage_name, project_root)
    return _compose_cmd(path, "down", "--remove-orphans", runner=runner)
