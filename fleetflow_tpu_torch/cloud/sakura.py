"""Sakura Cloud provider (the port's copy of
``fleetflow_tpu/cloud/sakura.py``).

Analog of fleetflow-cloud-sakura (SURVEY.md §2.7): server CRUD + power via
the `usacloud` CLI (usacloud.rs:21-66), a plan/apply CloudProvider over
declared servers (provider.rs), and startup-script support. The usacloud
runner is injectable; with the CLI absent `check_auth` is False and every
operation raises a clean CloudError.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Optional

from ..core.errors import CloudError
from ..core.model import CloudProviderDecl, ServerResource
from .action import Action, ActionType, ApplyResult, Plan
from .provider import (CloudProvider, ServerInfo, ServerProvider,
                       register_provider)
from .state import ProviderState, ResourceState

__all__ = ["SakuraProvider", "SakuraServerProvider"]

DEFAULT_ZONE = "tk1a"   # the dogfood zone (.fleetflow/fleet.kdl:14-24)


def _default_runner(args: list[str]) -> tuple[int, str]:
    if shutil.which("usacloud") is None:
        raise CloudError("usacloud CLI not found (install sakura cloud CLI)")
    proc = subprocess.run(["usacloud", *args], capture_output=True, text=True)
    return proc.returncode, proc.stdout if proc.returncode == 0 else proc.stderr


def parse_plan(plan: Optional[str]) -> tuple[int, int]:
    """'2core-4gb' -> (cpu, memory_gb) (provider.rs parse_plan:16).
    Unparseable or absent plans fall back to the 2core/4gb dogfood size."""
    if plan:
        import re as _re
        m = _re.fullmatch(r"(\d+)core-(\d+)gb", plan.strip().lower())
        if m:
            return max(int(m.group(1)), 1), max(int(m.group(2)), 1)
    return 2, 4


class SakuraServerProvider(ServerProvider):
    """usacloud.rs:21-66 CRUD + the note (startup-script) management of
    provider.rs:131-190: named scripts resolve to cloud notes —
    builtins (cloud/startup_scripts.py) are get-or-created, user scripts
    are looked up by name — and attach to server create; @@VAR@@
    placeholders are substituted via script_vars before registration."""

    name = "sakura"

    def __init__(self, zone: str = DEFAULT_ZONE, runner=None):
        self.zone = zone
        self.runner = runner or _default_runner

    # -- notes (startup scripts) --------------------------------------
    def find_note_by_name(self, name: str) -> Optional[str]:
        for row in self._json("note", "list"):
            if row.get("Name") == name:
                return str(row.get("ID", "")) or None
        return None

    def get_or_create_note(self, name: str, content: str) -> str:
        """provider.rs get_or_create_note:153 via `usacloud note`."""
        existing = self.find_note_by_name(name)
        if existing:
            return existing
        rows = self._json("note", "create", "--name", name,
                          "--content", content, "--class", "shell", "-y")
        nid = str(rows[0].get("ID", "")) if rows else ""
        if not nid:
            raise CloudError(f"note create for {name!r} returned no id")
        return nid

    def resolve_startup_scripts(self, names: list[str],
                                script_vars: Optional[dict] = None
                                ) -> list[str]:
        """Script names -> note ids. Builtins are registered on first use
        (with @@VAR@@ substitution); unknown non-builtin names must already
        exist as notes or the create fails loudly (provider.rs:148-177)."""
        from .startup_scripts import get_builtin_script, substitute_vars
        ids = []
        for name in names:
            content = get_builtin_script(name)
            if content is not None:
                content = substitute_vars(content, script_vars, context=name)
                # vars change content: key the note by name+vars hash so a
                # new CP endpoint doesn't silently reuse the stale note
                note_name = name
                if script_vars:
                    import hashlib as _h
                    note_name = (f"{name}-"
                                 f"{_h.sha256(content.encode()).hexdigest()[:8]}")
                ids.append(self.get_or_create_note(note_name, content))
                continue
            nid = self.find_note_by_name(name)
            if nid is None:
                raise CloudError(f"startup script {name!r} is not a builtin "
                                 f"and no note with that name exists")
            ids.append(nid)
        return ids

    # -- archives (disk sources) --------------------------------------
    def list_archives(self) -> list[dict]:
        """usacloud.rs list_archives:355."""
        return [{"id": str(r.get("ID", "")), "name": r.get("Name", ""),
                 "size_gb": r.get("SizeMB", 0) // 1024 or None}
                for r in self._json("archive", "list")]

    def find_archive_by_name(self, name: str) -> Optional[str]:
        """usacloud.rs find_archive_by_name:369."""
        for a in self.list_archives():
            if a["name"] == name:
                return a["id"] or None
        return None

    def resolve_archive_id(self, name_or_id: str) -> str:
        """Archive name or numeric id -> id (usacloud.rs
        resolve_archive_id:377: numeric ids pass through, names are looked
        up and a miss fails loudly)."""
        if name_or_id.isdigit():
            return name_or_id
        aid = self.find_archive_by_name(name_or_id)
        if aid is None:
            raise CloudError(f"archive not found: {name_or_id!r}")
        return aid

    # -- ssh keys ------------------------------------------------------
    def list_ssh_keys(self) -> list[dict]:
        """usacloud.rs list_ssh_keys:268."""
        return [{"id": str(r.get("ID", "")), "name": r.get("Name", "")}
                for r in self._json("ssh-key", "list")]

    def create_ssh_key(self, name: str, public_key: str) -> str:
        """usacloud.rs create_ssh_key:282; returns the key id."""
        rows = self._json("ssh-key", "create", "--name", name,
                          "--public-key", public_key, "-y")
        kid = str(rows[0].get("ID", "")) if rows else ""
        if not kid:
            raise CloudError(f"ssh-key create for {name!r} returned no id")
        return kid

    def resolve_ssh_keys(self, names_or_ids: list[str]) -> list[str]:
        """Key names resolve to ids (numeric ids pass through); a miss
        fails loudly rather than creating an unauthorized key."""
        keys = None
        out = []
        for k in names_or_ids:
            if k.isdigit():
                out.append(k)
                continue
            if keys is None:
                keys = {row["name"]: row["id"] for row in self.list_ssh_keys()}
            if k not in keys:
                raise CloudError(f"ssh key not found: {k!r}")
            out.append(keys[k])
        return out

    # -- disks ---------------------------------------------------------
    def all_disks(self) -> list[dict]:
        """Zone-wide disk inventory with owning server ids (`usacloud
        disk list`; `server read` omits disk detail the same way the
        reference notes for `server list`, usacloud.rs:254)."""
        return [{"id": str(r.get("ID", "")),
                 "size_gb": r.get("SizeMB", 0) // 1024,
                 "server_id": str((r.get("Server") or {}).get("ID", ""))}
                for r in self._json("disk", "list")]

    def server_disks(self, server_id: str) -> list[dict]:
        """Disk ids+sizes attached to one server."""
        return [{"id": d["id"], "size_gb": d["size_gb"]}
                for d in self.all_disks()
                if d["server_id"] == str(server_id)]

    def resize_disk(self, disk_id: str, new_size_gb: int) -> bool:
        """Grow a disk in place (`usacloud disk update --size`); Sakura
        disks never shrink, so smaller targets are refused here instead
        of failing serverside mid-apply."""
        current = None
        for r in self._json("disk", "read", disk_id):
            current = r.get("SizeMB", 0) // 1024
        if current is not None and new_size_gb < current:
            raise CloudError(
                f"disk {disk_id} is {current}GB; Sakura disks cannot "
                f"shrink to {new_size_gb}GB")
        rc, out = self.runner(["disk", "update", disk_id, "--size",
                               str(new_size_gb), "--zone", self.zone,
                               "-y", "--output-type", "json"])
        if rc != 0:
            raise CloudError(f"disk update failed: {out.strip()}")
        return True

    def find_servers_by_tag(self, tag: str) -> list[ServerInfo]:
        """usacloud.rs find_servers_by_tag:94."""
        return [s for s in self.list_servers() if tag in s.tags]

    def _json(self, *args: str) -> list[dict]:
        rc, out = self.runner([*args, "--zone", self.zone, "--output-type",
                               "json"])
        if rc != 0:
            raise CloudError(f"usacloud {' '.join(args)} failed: {out.strip()}")
        try:
            doc = json.loads(out or "[]")
        except json.JSONDecodeError:
            raise CloudError(f"usacloud returned non-JSON: {out[:200]}") from None
        return doc if isinstance(doc, list) else [doc]

    @staticmethod
    def _info(row: dict) -> ServerInfo:
        ifaces = row.get("Interfaces") or []
        ip = ifaces[0].get("IPAddress") if ifaces else None
        return ServerInfo(
            id=str(row.get("ID", "")),
            name=row.get("Name", ""),
            status={"up": "up", "down": "down"}.get(
                str(row.get("InstanceStatus", "")).lower(), "unknown"),
            ip=ip,
            plan=str(row.get("ServerPlan", {}).get("Name", "")) or None,
            zone=self_zone(row),
            tags=row.get("Tags") or [])

    def list_servers(self) -> list[ServerInfo]:
        return [self._info(r) for r in self._json("server", "list")]

    def get_server(self, server_id: str) -> Optional[ServerInfo]:
        for s in self.list_servers():
            if s.id == server_id or s.name == server_id:
                return s
        return None

    def create_server(self, spec: ServerResource,
                      script_vars: Optional[dict] = None) -> ServerInfo:
        """Create with disk + startup scripts (provider.rs
        create_server:102-190): the plan string ('2core-4gb') wins over
        capacity when present, the startup script resolves to note ids."""
        if spec.plan:
            cpu, mem_gb = parse_plan(spec.plan)
        else:
            cpu = int(max(spec.capacity.cpu, 1))
            mem_gb = int(max(spec.capacity.memory / 1024, 1))
        args = ["server", "create", "--name", spec.name,
                "--cpu", str(cpu), "--memory", str(mem_gb),
                "--disk-size", str(spec.disk_size or 40)]
        if spec.archive:
            # archive wins over os-type (provider.rs:163-166): names
            # resolve to ids, numeric ids pass through
            args += ["--disk-source-archive-id",
                     self.resolve_archive_id(spec.archive)]
        else:
            args += ["--os-type", spec.os or "ubuntu2204"]
        args.append("-y")
        if spec.startup_script:
            names = [s.strip() for s in spec.startup_script.split(",")
                     if s.strip()]
            for nid in self.resolve_startup_scripts(names, script_vars):
                args += ["--note-id", nid]
        for kid in self.resolve_ssh_keys(spec.ssh_keys):
            args += ["--ssh-key-ids", kid]
        for tag in spec.tags:
            args += ["--tags", tag]
        rows = self._json(*args)
        return self._info(rows[0]) if rows else ServerInfo(id="", name=spec.name)

    def delete_server(self, server_id: str, with_disks: bool = True) -> bool:
        """provider.rs delete_server:199: fleet nodes own their disks, so
        deletion removes them by default (no orphaned disk billing)."""
        args = ["server", "delete", server_id, "--zone", self.zone, "-y",
                "--output-type", "json"]
        if with_disks:
            args.insert(3, "--with-disks")
        rc, _ = self.runner(args)
        return rc == 0

    def power_on(self, server_id: str) -> bool:
        rc, _ = self.runner(["server", "boot", server_id, "--zone",
                             self.zone, "-y"])
        return rc == 0

    def power_off(self, server_id: str) -> bool:
        rc, _ = self.runner(["server", "shutdown", server_id, "--zone",
                             self.zone, "-y"])
        return rc == 0


def self_zone(row: dict) -> Optional[str]:
    z = row.get("Zone")
    if isinstance(z, dict):
        return z.get("Name")
    return z


class SakuraProvider(CloudProvider):
    """Declarative plan/apply over declared servers (provider.rs, 875L)."""

    name = "sakura"

    def __init__(self, zone: str = DEFAULT_ZONE, runner=None):
        self.servers = SakuraServerProvider(zone=zone, runner=runner)

    def check_auth(self) -> bool:
        try:
            rc, _ = self.servers.runner(["auth-status"])
            return rc == 0
        except CloudError:
            return False

    def get_state(self) -> ProviderState:
        st = ProviderState(provider=self.name)
        for s in self.servers.list_servers():
            st.upsert(ResourceState(id=s.id, type="server", name=s.name,
                                    attributes={"status": s.status,
                                                "ip": s.ip, "plan": s.plan,
                                                "tags": s.tags}))
        return st

    def plan(self, decl: CloudProviderDecl,
             servers: list[ServerResource]) -> Plan:
        current = {r.name: r for r in self.get_state().by_type("server")}
        plan = Plan(provider=self.name)
        desired_names = set()
        # one zone-wide disk listing serves every declared server (the
        # listing is zone-global anyway; per-spec fetches would cost one
        # CLI roundtrip per server)
        disks_by_server: Optional[dict[str, list[dict]]] = None
        for spec in servers:
            if spec.provider not in (None, self.name):
                continue
            desired_names.add(spec.name)
            if spec.name in current:
                # a declared disk size differing from the attached disk
                # becomes an in-place resize action (provider.rs disk
                # modify flow); shrinks surface in the plan too, and
                # apply refuses them loudly via resize_disk
                resized = False
                if spec.disk_size:
                    if disks_by_server is None:
                        disks_by_server = {}
                        for d in self.servers.all_disks():
                            disks_by_server.setdefault(
                                d["server_id"], []).append(d)
                    disks = disks_by_server.get(str(current[spec.name].id),
                                                [])
                    # the KDL disk-size declares the BOOT disk (the one
                    # `server create --disk-size` made, i.e. the oldest =
                    # lowest id); secondary data disks are out of scope
                    # and must not be resized or flagged
                    boot = min((d for d in disks if d["size_gb"]),
                               key=lambda d: int(d["id"] or 0), default=None)
                    if boot is not None and boot["size_gb"] != spec.disk_size:
                        kind = ("resize" if boot["size_gb"] < spec.disk_size
                                else "SHRINK (will be refused)")
                        plan.actions.append(Action(
                            ActionType.UPDATE, "disk", spec.name,
                            f"{kind} {boot['size_gb']}gb -> "
                            f"{spec.disk_size}gb",
                            current={"disk_id": boot["id"],
                                     "size_gb": boot["size_gb"]},
                            desired={"size_gb": spec.disk_size}))
                        resized = True
                if not resized:
                    plan.actions.append(Action(
                        ActionType.NOOP, "server", spec.name, "exists"))
            else:
                # full spec rides the plan so apply creates what was
                # declared (disk, plan, scripts), not a bare default
                plan.actions.append(Action(
                    ActionType.CREATE, "server", spec.name,
                    f"plan={spec.plan or 'default'} "
                    f"disk={spec.disk_size or 40}gb"
                    + (f" scripts={spec.startup_script}"
                       if spec.startup_script else ""),
                    desired={"name": spec.name, "plan": spec.plan,
                             "disk_size": spec.disk_size, "os": spec.os,
                             "archive": spec.archive,
                             "startup_script": spec.startup_script,
                             "ssh_keys": spec.ssh_keys, "tags": spec.tags,
                             # per-server script variables; the provider
                             # declaration's script-vars option supplies
                             # fleet-wide ones (CP endpoint, CA)
                             "script_vars": dict(
                                 (decl.options or {}).get("script-vars")
                                 or {}, SERVER_SLUG=spec.name)}))
        for name in current:
            if name not in desired_names:
                plan.actions.append(Action(
                    ActionType.DELETE, "server", name, "not in config",
                    current={"id": current[name].id}))
        return plan

    def apply(self, plan: Plan) -> ApplyResult:
        result = ApplyResult()
        for action in plan.changes:
            try:
                if action.type is ActionType.CREATE:
                    d = action.desired or {}
                    info = self.servers.create_server(
                        ServerResource(
                            name=action.resource_id, plan=d.get("plan"),
                            disk_size=d.get("disk_size"), os=d.get("os"),
                            archive=d.get("archive"),
                            startup_script=d.get("startup_script"),
                            ssh_keys=list(d.get("ssh_keys") or []),
                            tags=list(d.get("tags") or [])),
                        script_vars=d.get("script_vars") or None)
                    if not info.id:
                        raise CloudError(
                            f"create of {action.resource_id} returned no id")
                    result.outputs[action.resource_id] = {"id": info.id,
                                                          "ip": info.ip}
                elif (action.type is ActionType.UPDATE
                      and action.resource_type == "disk"):
                    self.servers.resize_disk(
                        (action.current or {})["disk_id"],
                        (action.desired or {})["size_gb"])
                elif action.type is ActionType.DELETE:
                    if not self.servers.delete_server(
                            (action.current or {}).get("id",
                                                       action.resource_id)):
                        raise CloudError(
                            f"delete of {action.resource_id} failed")
                result.succeeded.append(action)
            except CloudError as e:
                result.failed.append((action, str(e)))
        return result


register_provider("sakura", SakuraProvider)
