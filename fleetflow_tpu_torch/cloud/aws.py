"""AWS EC2 provider (the port's copy of ``fleetflow_tpu/cloud/aws.py``).

Analog of fleetflow-cloud-aws (SURVEY.md §2.7). The reference feature-gates
this crate to dodge 6-7 GB builds (root Cargo.toml:39-45); this build
shells to the `aws` CLI for the same reason (no SDK dependency): instance
CRUD + power over EC2, with the instance-type mapping the reference keeps
in its models.
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

__all__ = ["AwsServerProvider", "AwsProvider", "instance_type_for"]

# plan -> instance type mapping (aws crate instance-type models)
_PLAN_MAP = {
    "nano": "t3.nano", "micro": "t3.micro", "small": "t3.small",
    "medium": "t3.medium", "large": "t3.large", "xlarge": "t3.xlarge",
}

# (vcpu, mem_gb) -> type ladder; picked as the smallest type satisfying
# BOTH axes (the reference keeps the same table in its instance-type
# models, fleetflow-cloud-aws instance type mapping)
_SIZE_LADDER = [
    (2, 1, "t3.micro"), (2, 2, "t3.small"), (2, 4, "t3.medium"),
    (2, 8, "t3.large"), (4, 16, "t3.xlarge"), (8, 32, "t3.2xlarge"),
    (8, 64, "m5.4xlarge"), (16, 128, "m5.8xlarge"),
]


def instance_type_for(plan: Optional[str], capacity_cpu: float = 2.0,
                      capacity_mem_mb: float = 4096.0) -> str:
    """Resolve an instance type from a plan alias, a literal type, or the
    declared capacity (smallest ladder entry covering cpu AND memory)."""
    if plan in _PLAN_MAP:
        return _PLAN_MAP[plan]
    if plan:
        return plan                    # already an instance type
    mem_gb = capacity_mem_mb / 1024.0
    for vcpu, gb, itype in _SIZE_LADDER:
        if capacity_cpu <= vcpu and mem_gb <= gb:
            return itype
    return "m5.8xlarge"


def _default_runner(args: list[str]) -> tuple[int, str]:
    if shutil.which("aws") is None:
        raise CloudError("aws CLI not found")
    proc = subprocess.run(["aws", *args], capture_output=True, text=True)
    return proc.returncode, proc.stdout if proc.returncode == 0 else proc.stderr


_MANAGED_TAG = "fleetflow:managed"


class AwsNetwork:
    """Subnet + security-group management (cloud_provider.rs:53-222).
    Resources created here carry the fleetflow:managed tag so list/destroy
    only ever touch what we made."""

    def __init__(self, provider: "AwsServerProvider"):
        self._p = provider

    # -- subnets -------------------------------------------------------
    def create_subnet(self, name: str, vpc_id: str, cidr: str,
                      az: Optional[str] = None) -> str:
        args = ["ec2", "create-subnet", "--vpc-id", vpc_id,
                "--cidr-block", cidr,
                "--tag-specifications",
                ("ResourceType=subnet,Tags=[{Key=Name,Value=%s},"
                 "{Key=%s,Value=true}]" % (name, _MANAGED_TAG))]
        if az:
            args += ["--availability-zone", az]
        doc = self._p._json(*args)
        sid = doc.get("Subnet", {}).get("SubnetId", "")
        if not sid:
            raise CloudError(f"create-subnet for {name!r} returned no id")
        return sid

    def delete_subnet(self, subnet_id: str) -> bool:
        rc, _ = self._p.runner(["ec2", "delete-subnet", "--subnet-id",
                                subnet_id, "--region", self._p.region,
                                "--output", "json"])
        return rc == 0

    def list_managed_subnets(self) -> list[tuple[str, str]]:
        """(subnet_id, name) pairs carrying the managed tag
        (cloud_provider.rs list_managed_subnets:96)."""
        doc = self._p._json("ec2", "describe-subnets", "--filters",
                            f"Name=tag:{_MANAGED_TAG},Values=true")
        out = []
        for s in doc.get("Subnets", []):
            name = next((t["Value"] for t in s.get("Tags", [])
                         if t.get("Key") == "Name"), "")
            out.append((s.get("SubnetId", ""), name))
        return out

    # -- security groups ----------------------------------------------
    def find_security_group(self, name: str) -> Optional[str]:
        doc = self._p._json("ec2", "describe-security-groups", "--filters",
                            f"Name=group-name,Values={name}")
        groups = doc.get("SecurityGroups", [])
        return groups[0].get("GroupId") if groups else None

    def create_security_group(self, name: str, vpc_id: str,
                              description: str = "fleetflow managed") -> str:
        doc = self._p._json(
            "ec2", "create-security-group", "--group-name", name,
            "--description", description, "--vpc-id", vpc_id,
            "--tag-specifications",
            ("ResourceType=security-group,Tags=[{Key=Name,Value=%s},"
             "{Key=%s,Value=true}]" % (name, _MANAGED_TAG)))
        gid = doc.get("GroupId", "")
        if not gid:
            raise CloudError(f"create-security-group {name!r} returned no id")
        return gid

    def authorize_ingress(self, sg_id: str, rules: list[dict]) -> None:
        """rules: [{port, protocol?, cidr?}] -> one authorize call each
        (cloud_provider.rs authorize_ingress:173). Duplicate-rule errors
        are tolerated: ensure_security_group re-runs on every apply."""
        for rule in rules:
            rc, out = self._p.runner([
                "ec2", "authorize-security-group-ingress",
                "--group-id", sg_id,
                "--protocol", str(rule.get("protocol", "tcp")),
                "--port", str(rule["port"]),
                "--cidr", str(rule.get("cidr", "0.0.0.0/0")),
                "--region", self._p.region, "--output", "json"])
            if rc != 0 and "Duplicate" not in out:
                raise CloudError(f"authorize ingress {rule} failed: "
                                 f"{out.strip()}")

    def ensure_security_group(self, name: str, vpc_id: str,
                              rules: list[dict]) -> str:
        gid = self.find_security_group(name)
        if gid is None:
            gid = self.create_security_group(name, vpc_id)
        self.authorize_ingress(gid, rules)
        return gid

    def delete_security_group(self, sg_id: str) -> bool:
        rc, _ = self._p.runner(["ec2", "delete-security-group",
                                "--group-id", sg_id, "--region",
                                self._p.region, "--output", "json"])
        return rc == 0


class AwsServerProvider(ServerProvider):
    name = "aws"

    def __init__(self, region: str = "ap-northeast-1", runner=None):
        self.region = region
        self.runner = runner or _default_runner
        self.network = AwsNetwork(self)

    def _json(self, *args: str) -> dict:
        rc, out = self.runner([*args, "--region", self.region,
                               "--output", "json"])
        if rc != 0:
            raise CloudError(f"aws {' '.join(args[:3])} failed: {out.strip()}")
        try:
            return json.loads(out or "{}")
        except json.JSONDecodeError:
            raise CloudError(f"aws returned non-JSON: {out[:200]}") from None

    @staticmethod
    def _info(inst: dict) -> ServerInfo:
        name = next((t["Value"] for t in inst.get("Tags", [])
                     if t.get("Key") == "Name"), inst.get("InstanceId", ""))
        return ServerInfo(
            id=inst.get("InstanceId", ""),
            name=name,
            status={"running": "up", "stopped": "down"}.get(
                inst.get("State", {}).get("Name", ""), "unknown"),
            ip=inst.get("PublicIpAddress") or inst.get("PrivateIpAddress"),
            plan=inst.get("InstanceType"),
            zone=inst.get("Placement", {}).get("AvailabilityZone"),
            tags=[t["Value"] for t in inst.get("Tags", [])
                  if t.get("Key") != "Name"])

    def list_servers(self) -> list[ServerInfo]:
        doc = self._json("ec2", "describe-instances")
        out = []
        for res in doc.get("Reservations", []):
            for inst in res.get("Instances", []):
                if inst.get("State", {}).get("Name") != "terminated":
                    out.append(self._info(inst))
        return out

    def get_server(self, server_id: str) -> Optional[ServerInfo]:
        for s in self.list_servers():
            if s.id == server_id or s.name == server_id:
                return s
        return None

    def create_server(self, spec: ServerResource,
                      subnet_id: Optional[str] = None,
                      security_group_ids: Optional[list[str]] = None,
                      script_vars: Optional[dict] = None) -> ServerInfo:
        """run-instances with the network objects + startup script
        (cloud_provider.rs create path): instance type from plan/capacity
        (cpu AND memory), builtin startup scripts ride --user-data with
        @@VAR@@ substitution, root disk size from disk_size."""
        args = ["ec2", "run-instances",
                "--instance-type", instance_type_for(spec.plan,
                                                     spec.capacity.cpu,
                                                     spec.capacity.memory),
                "--tag-specifications",
                ("ResourceType=instance,Tags=[{Key=Name,Value=%s},"
                 "{Key=%s,Value=true}]" % (spec.name, _MANAGED_TAG)),
                "--count", "1"]
        if spec.os:
            args += ["--image-id", spec.os]
        if subnet_id:
            args += ["--subnet-id", subnet_id]
        if security_group_ids:
            args += ["--security-group-ids", *security_group_ids]
        if spec.ssh_keys:
            args += ["--key-name", spec.ssh_keys[0]]
        if spec.disk_size:
            args += ["--block-device-mappings",
                     json.dumps([{"DeviceName": "/dev/sda1",
                                  "Ebs": {"VolumeSize": spec.disk_size,
                                          "DeleteOnTermination": True}}])]
        if spec.startup_script:
            from .startup_scripts import get_builtin_script, substitute_vars
            content = (get_builtin_script(spec.startup_script)
                       or spec.startup_script)
            content = substitute_vars(content, script_vars,
                                      context=spec.startup_script)
            # raw text: the AWS CLI base64-encodes --user-data itself;
            # pre-encoding here would double-encode and cloud-init would
            # see base64 soup instead of a shebang
            args += ["--user-data", content]
        doc = self._json(*args)
        instances = doc.get("Instances", [])
        return (self._info(instances[0]) if instances
                else ServerInfo(id="", name=spec.name))

    def delete_server(self, server_id: str) -> bool:
        rc, _ = self.runner(["ec2", "terminate-instances", "--instance-ids",
                             server_id, "--region", self.region,
                             "--output", "json"])
        return rc == 0

    def power_on(self, server_id: str) -> bool:
        rc, _ = self.runner(["ec2", "start-instances", "--instance-ids",
                             server_id, "--region", self.region,
                             "--output", "json"])
        return rc == 0

    def power_off(self, server_id: str) -> bool:
        rc, _ = self.runner(["ec2", "stop-instances", "--instance-ids",
                             server_id, "--region", self.region,
                             "--output", "json"])
        return rc == 0


class AwsProvider(CloudProvider):
    name = "aws"

    def __init__(self, region: str = "ap-northeast-1", runner=None):
        self.servers = AwsServerProvider(region=region, runner=runner)

    def check_auth(self) -> bool:
        try:
            rc, _ = self.servers.runner(["sts", "get-caller-identity",
                                         "--output", "json"])
            return rc == 0
        except CloudError:
            return False

    def get_state(self) -> ProviderState:
        st = ProviderState(provider=self.name)
        for s in self.servers.list_servers():
            st.upsert(ResourceState(id=s.id, type="server", name=s.name,
                                    attributes={"status": s.status,
                                                "ip": s.ip,
                                                "type": s.plan}))
        return st

    def plan(self, decl: CloudProviderDecl,
             servers: list[ServerResource]) -> Plan:
        """Diff model incl. network objects: when the provider declaration
        carries `vpc` (+ optional `subnet-cidr`, `ingress` port list), the
        plan ensures one managed security group (and subnet) ahead of the
        instances that reference them (cloud_provider.rs plan path)."""
        current = {r.name: r for r in self.get_state().by_type("server")}
        plan = Plan(provider=self.name)
        opts = decl.options or {}
        vpc = opts.get("vpc")
        sg_name = sn_name = None
        if vpc:
            sg_name = opts.get("security-group",
                               f"fleetflow-{decl.name or self.name}")
            if self.servers.network.find_security_group(sg_name) is None:
                plan.actions.append(Action(
                    ActionType.CREATE, "security_group", sg_name,
                    f"vpc={vpc} ingress={opts.get('ingress', [])}",
                    desired={"vpc": vpc,
                             "ingress": list(opts.get("ingress", []))}))
            if opts.get("subnet-cidr"):
                have = {n for _, n in
                        self.servers.network.list_managed_subnets()}
                sn_name = opts.get("subnet",
                                   f"fleetflow-{self.servers.region}")
                if sn_name not in have:
                    plan.actions.append(Action(
                        ActionType.CREATE, "subnet", sn_name,
                        f"cidr={opts['subnet-cidr']}",
                        desired={"vpc": vpc, "cidr": opts["subnet-cidr"],
                                 "az": opts.get("az")}))
        desired = set()
        for spec in servers:
            if spec.provider not in (None, self.name):
                continue
            desired.add(spec.name)
            if spec.name in current:
                plan.actions.append(Action(ActionType.NOOP, "server",
                                           spec.name, "exists"))
            else:
                plan.actions.append(Action(
                    ActionType.CREATE, "server", spec.name,
                    instance_type_for(spec.plan, spec.capacity.cpu,
                                      spec.capacity.memory),
                    desired={"name": spec.name, "plan": spec.plan,
                             "os": spec.os, "disk_size": spec.disk_size,
                             "startup_script": spec.startup_script,
                             "ssh_keys": spec.ssh_keys,
                             "cpu": spec.capacity.cpu,
                             "memory": spec.capacity.memory,
                             # network objects BY NAME: apply resolves them
                             # whether created this run or pre-existing
                             "sg_name": sg_name, "subnet_name": sn_name,
                             "script_vars": dict(
                                 opts.get("script-vars") or {},
                                 SERVER_SLUG=spec.name)}))
        for name, res in current.items():
            if name not in desired:
                plan.actions.append(Action(ActionType.DELETE, "server", name,
                                           "not in config",
                                           current={"id": res.id}))
        return plan

    def apply(self, plan: Plan) -> ApplyResult:
        result = ApplyResult()
        # name -> id caches; seeded by CREATE actions in this run, filled
        # by lookup for pre-existing network objects (apply #2 onward must
        # wire new servers into the SG/subnet created by apply #1)
        sg_cache: dict[str, str] = {}
        subnet_cache: dict[str, str] = {}

        def resolve_sg(name: Optional[str]) -> Optional[list[str]]:
            if not name:
                return None
            if name not in sg_cache:
                gid = self.servers.network.find_security_group(name)
                if gid is None:
                    raise CloudError(f"security group {name!r} not found")
                sg_cache[name] = gid
            return [sg_cache[name]]

        def resolve_subnet(name: Optional[str]) -> Optional[str]:
            if not name:
                return None
            if name not in subnet_cache:
                for sid, n in self.servers.network.list_managed_subnets():
                    subnet_cache.setdefault(n, sid)
                if name not in subnet_cache:
                    raise CloudError(f"managed subnet {name!r} not found")
            return subnet_cache[name]

        for action in plan.changes:
            try:
                if (action.type is ActionType.CREATE
                        and action.resource_type == "security_group"):
                    d = action.desired or {}
                    gid = self.servers.network.ensure_security_group(
                        action.resource_id, d["vpc"],
                        [{"port": p} for p in d.get("ingress", [])])
                    sg_cache[action.resource_id] = gid
                    result.outputs[action.resource_id] = {"id": gid}
                elif (action.type is ActionType.CREATE
                        and action.resource_type == "subnet"):
                    d = action.desired or {}
                    sid = self.servers.network.create_subnet(
                        action.resource_id, d["vpc"], d["cidr"],
                        az=d.get("az"))
                    subnet_cache[action.resource_id] = sid
                    result.outputs[action.resource_id] = {"id": sid}
                elif action.type is ActionType.CREATE:
                    d = action.desired or {}
                    from ..core.model import ResourceSpec
                    spec = ServerResource(
                        name=action.resource_id, plan=d.get("plan"),
                        os=d.get("os"), disk_size=d.get("disk_size"),
                        startup_script=d.get("startup_script"),
                        ssh_keys=list(d.get("ssh_keys") or []))
                    if d.get("cpu") or d.get("memory"):
                        spec.capacity = ResourceSpec(
                            cpu=float(d.get("cpu") or 2.0),
                            memory=float(d.get("memory") or 4096.0))
                    info = self.servers.create_server(
                        spec, subnet_id=resolve_subnet(d.get("subnet_name")),
                        security_group_ids=resolve_sg(d.get("sg_name")),
                        script_vars=d.get("script_vars") or None)
                    if not info.id:
                        raise CloudError(
                            f"create of {action.resource_id} returned no id")
                    result.outputs[action.resource_id] = {"id": info.id}
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


register_provider("aws", AwsProvider)
