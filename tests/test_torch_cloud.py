"""The port's cloud providers, ssh wrapper, startup scripts and registry
deploy (fleetflow_tpu_torch.cloud, .registry) against the reference's, on
the CPU.

The cases of tests/test_registry_build_cloud.py's TestCloud,
TestSakuraArchivesDisksKeys, TestCloudflareManagement and
TestRegistryDeploy (the registry is built from its model: the registry's
KDL parser is not ported), each run on both packages with the same fake
runner or transport: every case holds the reference test's assertions on
each package, and the command lines (and REST calls) each package issues,
with what each returns, are equal.
"""

from __future__ import annotations

import datetime
import importlib
import json
from types import SimpleNamespace

import pytest

_MODS = dict(cloud="cloud", sakura="cloud.sakura", aws="cloud.aws",
             cloudflare="cloud.cloudflare", tailscale="cloud.tailscale",
             ssh="cloud.ssh", scripts="cloud.startup_scripts",
             provider="cloud.provider", model="core.model",
             errors="core.errors", parser="core.parser",
             serialize="core.serialize", registry="registry",
             reg_model="registry.model", reg_deploy="registry.deploy")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)


def _plain(v):
    """A comparable form of a case's outputs (dataclasses and enums as
    their fields and values)."""
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if hasattr(v, "__dataclass_fields__"):
        return {k: _plain(getattr(v, k)) for k in v.__dataclass_fields__}
    if hasattr(v, "value") and type(v).__module__.endswith("action"):
        return v.value
    return v


# --------------------------------------------------------------------------
# the cases: each runs on one package, asserts the reference test's
# contract, and returns (calls, outputs) for the cross-package comparison
# --------------------------------------------------------------------------

def case_plan_diff_and_apply(P):
    listing = [{"ID": "100", "Name": "web-1", "InstanceStatus": "up",
                "Interfaces": [], "Tags": []}]
    calls = []

    def runner(args):
        calls.append(args)
        if args[:2] == ["server", "list"]:
            return 0, json.dumps(listing)
        if args[:2] == ["server", "create"]:
            return 0, json.dumps([{"ID": "200",
                                   "Name": args[args.index("--name") + 1],
                                   "InstanceStatus": "up"}])
        return 0, "{}"
    provider = P.sakura.SakuraProvider(runner=runner)
    decl = P.model.CloudProviderDecl(name="sakura")
    SR = P.model.ServerResource
    plan = provider.plan(decl, [SR(name="web-1"), SR(name="web-2")])
    kinds = {(a.type.value, a.resource_id) for a in plan.actions}
    assert ("noop", "web-1") in kinds and ("create", "web-2") in kinds
    assert plan.summary() == "1 to create"
    result = provider.apply(plan)
    assert result.ok and result.outputs["web-2"]["id"] == "200"
    plan2 = provider.plan(decl, [SR(name="web-2")])
    kinds2 = {(a.type.value, a.resource_id) for a in plan2.actions}
    assert ("delete", "web-1") in kinds2
    return calls, [sorted(kinds), result.outputs, sorted(kinds2)]


def case_state_tree_persistence(P, tmp_path):
    st = P.cloud.GlobalState.load(str(tmp_path))
    st.provider("sakura").upsert(P.cloud.ResourceState(
        id="100", type="server", name="web-1",
        attributes={"ip": "10.0.0.1"}))
    st.save()
    st2 = P.cloud.GlobalState.load(str(tmp_path))
    res = st2.provider("sakura").resources["100"]
    assert res.attributes["ip"] == "10.0.0.1"
    assert st2.provider("sakura").by_type("server")[0].name == "web-1"
    files = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    doc = json.loads(next(p for p in tmp_path.rglob("*")
                          if p.is_file()).read_text())
    timeless = {k: v for k, v in _plain(res).items()
                if k not in ("created_at", "updated_at")}
    return [], [timeless, files, sorted(doc)]


def case_cloudflare_ensure_record(P):
    records: dict = {}
    counter = [0]
    calls = []

    def transport(method, path, body):
        calls.append([method, path, body])
        if method == "GET" and path.startswith("/zones?"):
            return {"success": True, "result": [{"id": "z1"}]}
        if method == "GET" and "dns_records" in path:
            name = path.split("name=")[1].split("&")[0]
            return {"success": True,
                    "result": [r for r in records.values()
                               if r["name"] == name]}
        if method == "POST":
            counter[0] += 1
            rec = dict(body, id=f"r{counter[0]}")
            records[rec["id"]] = rec
            return {"success": True, "result": rec}
        if method == "PATCH":
            rid = path.rsplit("/", 1)[1]
            records[rid].update(body)
            return {"success": True, "result": records[rid]}
        return {"success": True, "result": None}
    dns = P.cloudflare.CloudflareDns(token="t", transport=transport)
    r1 = dict(dns.ensure_record("example.com", "app.example.com", "A",
                                "1.1.1.1"))
    assert r1["content"] == "1.1.1.1"
    r2 = dict(dns.ensure_record("example.com", "app.example.com", "A",
                                "1.1.1.1", ttl=r1.get("ttl", 300),
                                proxied=r1.get("proxied", False)))
    assert r2["id"] == r1["id"] and counter[0] == 1
    r3 = dict(dns.ensure_record("example.com", "app.example.com", "A",
                                "2.2.2.2"))
    assert r3["id"] == r1["id"] and r3["content"] == "2.2.2.2"
    return calls, [r1, r2, r3]


def case_tailscale_peer_status(P):
    status_json = json.dumps({"Peer": {
        "k1": {"HostName": "Web-1", "TailscaleIPs": ["100.1.1.1"],
               "Online": True},
        "k2": {"HostName": "web-2", "Online": False,
               "LastSeen": "2026-07-29T00:00:00Z"}}})
    calls = []
    peers = P.tailscale.get_peers(
        runner=lambda args: (calls.append(args), (0, status_json))[1])
    assert [p.hostname for p in peers] == ["web-1", "web-2"]
    seen = datetime.datetime(2026, 7, 29,
                             tzinfo=datetime.timezone.utc).timestamp()
    res = P.tailscale.resolve_peer_status
    out = [res(peers[0]), res(peers[1], now=seen + 100),
           res(peers[1], now=seen + 10000),
           res(P.tailscale.Peer(hostname="x"), now=0)]
    assert out == ["online", "online", "offline", "offline"]
    return calls, [_plain(peers), out]


def case_provider_registry(P):
    names = set(P.cloud.provider_names())
    assert {"sakura", "cloudflare", "aws"} <= names
    with pytest.raises(P.errors.CloudError, match="unknown cloud provider"):
        P.cloud.get_provider("digitalocean")
    return [], sorted(names)


def case_aws_instance_mapping(P):
    f = P.aws.instance_type_for
    out = [f("micro"), f("c5.large"), f(None, 1, 1024), f(None, 2, 8192),
           f(None, 2, 16 * 1024), f(None, 16, 4096),
           f(None, 64, 1024 * 1024)]
    assert out == ["t3.micro", "c5.large", "t3.micro", "t3.large",
                   "t3.xlarge", "m5.8xlarge", "m5.8xlarge"]
    return [], out


def case_sakura_plan_parsing(P):
    out = [P.sakura.parse_plan(x) for x in ("2core-4gb", "8CORE-32GB",
                                            "weird", None)]
    assert out == [(2, 4), (8, 32), (2, 4), (2, 4)]
    return [], out


def case_sakura_create_with_disk_and_startup_scripts(P):
    notes: dict = {}
    calls = []

    def runner(args):
        calls.append(args)
        if args[:2] == ["note", "list"]:
            return 0, json.dumps([{"ID": nid, "Name": name}
                                  for name, nid in notes.items()])
        if args[:2] == ["note", "create"]:
            name = args[args.index("--name") + 1]
            notes[name] = str(700 + len(notes))
            return 0, json.dumps([{"ID": notes[name], "Name": name}])
        if args[:2] == ["server", "create"]:
            return 0, json.dumps([{"ID": "900", "Name": "w1",
                                   "InstanceStatus": "up"}])
        return 0, "{}"
    p = P.sakura.SakuraServerProvider(runner=runner)
    spec = P.model.ServerResource(name="w1", plan="4core-8gb", disk_size=100,
                                  startup_script="docker-setup,agent-setup",
                                  tags=["fleet"])
    vars_ = {"CP_ENDPOINT": "cp.example:4510", "SERVER_SLUG": "w1",
             "CA_PEM_B64": ""}
    info = p.create_server(spec, script_vars=vars_)
    assert info.id == "900"
    create = next(a for a in calls if a[:2] == ["server", "create"])
    assert create[create.index("--cpu") + 1] == "4"
    assert create[create.index("--memory") + 1] == "8"
    assert create[create.index("--disk-size") + 1] == "100"
    note_ids = [create[i + 1] for i, a in enumerate(create)
                if a == "--note-id"]
    assert len(note_ids) == 2 and all(n in notes.values() for n in note_ids)
    created = next(a for a in calls if a[:2] == ["note", "create"]
                   and "agent-setup" in a[a.index("--name") + 1])
    assert "cp.example:4510" in created[created.index("--content") + 1]
    n_created = sum(1 for a in calls if a[:2] == ["note", "create"])
    p.create_server(spec, script_vars=vars_)
    assert sum(1 for a in calls if a[:2] == ["note", "create"]) == n_created
    return calls, [_plain(info), notes]


def case_sakura_unknown_script_fails_loudly(P):
    calls = []

    def runner(args):
        calls.append(args)
        return (0, "[]") if args[:2] == ["note", "list"] else (0, "{}")
    p = P.sakura.SakuraServerProvider(runner=runner)
    with pytest.raises(P.errors.CloudError, match="not a builtin") as e:
        p.create_server(P.model.ServerResource(name="w1",
                                               startup_script="my-script"))
    return calls, str(e.value)


def case_sakura_delete_removes_disks(P):
    calls = []
    p = P.sakura.SakuraServerProvider(
        runner=lambda a: (calls.append(a), (0, "{}"))[1])
    p.delete_server("900")
    assert "--with-disks" in calls[0]
    p.delete_server("900", with_disks=False)
    assert "--with-disks" not in calls[1]
    return calls, None


def case_sakura_apply_creates_declared_spec(P):
    calls = []

    def runner(args):
        calls.append(args)
        if args[:2] == ["server", "list"]:
            return 0, "[]"
        if args[:2] == ["server", "create"]:
            return 0, json.dumps([{"ID": "300", "Name": "db-1",
                                   "InstanceStatus": "up"}])
        return 0, "{}"
    p = P.sakura.SakuraProvider(runner=runner)
    plan = p.plan(P.model.CloudProviderDecl(name="sakura"),
                  [P.model.ServerResource(name="db-1", plan="4core-8gb",
                                          disk_size=200)])
    res = p.apply(plan)
    assert res.ok
    create = next(a for a in calls if a[:2] == ["server", "create"])
    assert create[create.index("--disk-size") + 1] == "200"
    assert create[create.index("--cpu") + 1] == "4"
    return calls, [res.ok, res.outputs]


def case_aws_security_group_and_subnet(P):
    calls = []
    sgs: dict = {}

    def runner(args):
        calls.append(args)
        if args[:2] == ["ec2", "describe-security-groups"]:
            name = args[args.index("--filters") + 1].split("=")[-1]
            hit = sgs.get(name)
            return 0, json.dumps(
                {"SecurityGroups": [{"GroupId": hit}] if hit else []})
        if args[:2] == ["ec2", "create-security-group"]:
            name = args[args.index("--group-name") + 1]
            sgs[name] = f"sg-{len(sgs)}"
            return 0, json.dumps({"GroupId": sgs[name]})
        if args[:2] == ["ec2", "create-subnet"]:
            return 0, json.dumps({"Subnet": {"SubnetId": "subnet-1"}})
        if args[:2] == ["ec2", "describe-subnets"]:
            return 0, json.dumps({"Subnets": [
                {"SubnetId": "subnet-1",
                 "Tags": [{"Key": "Name", "Value": "net-a"}]}]})
        return 0, "{}"
    net = P.aws.AwsServerProvider(runner=runner).network
    gid = net.ensure_security_group("fleet-sg", "vpc-1",
                                    [{"port": 22}, {"port": 443}])
    assert gid == "sg-0"
    ingress = [a for a in calls
               if a[:2] == ["ec2", "authorize-security-group-ingress"]]
    assert len(ingress) == 2 and ingress[0][ingress[0].index("--port")
                                            + 1] == "22"
    assert net.ensure_security_group("fleet-sg", "vpc-1",
                                     [{"port": 22}]) == "sg-0"
    assert sum(1 for a in calls
               if a[:2] == ["ec2", "create-security-group"]) == 1
    sid = net.create_subnet("net-a", "vpc-1", "10.0.1.0/24", az="apne1-az1")
    assert sid == "subnet-1"
    subnets = net.list_managed_subnets()
    assert subnets == [("subnet-1", "net-a")]
    return calls, [gid, sid, subnets]


def case_aws_create_with_network_disk_and_userdata(P):
    calls = []

    def runner(args):
        calls.append(args)
        if args[:2] == ["ec2", "run-instances"]:
            return 0, json.dumps({"Instances": [
                {"InstanceId": "i-1", "State": {"Name": "running"},
                 "Tags": [{"Key": "Name", "Value": "w1"}]}]})
        return 0, "{}"
    p = P.aws.AwsServerProvider(runner=runner)
    spec = P.model.ServerResource(name="w1", disk_size=120,
                                  startup_script="docker-setup",
                                  ssh_keys=["ops-key"])
    info = p.create_server(spec, subnet_id="subnet-1",
                           security_group_ids=["sg-0"])
    assert info.id == "i-1"
    run = calls[0]
    assert run[run.index("--subnet-id") + 1] == "subnet-1"
    assert run[run.index("--security-group-ids") + 1] == "sg-0"
    assert run[run.index("--key-name") + 1] == "ops-key"
    bdm = json.loads(run[run.index("--block-device-mappings") + 1])
    assert bdm[0]["Ebs"]["VolumeSize"] == 120
    ud = run[run.index("--user-data") + 1]
    assert ud.startswith("#!/bin/bash") and "docker" in ud
    return calls, _plain(info)


def _aws_runner(calls, existing: bool):
    def runner(args):
        calls.append(args)
        if args[:2] == ["ec2", "describe-instances"]:
            return 0, json.dumps({"Reservations": []})
        if args[:2] == ["ec2", "describe-security-groups"]:
            return 0, json.dumps({"SecurityGroups": [{"GroupId": "sg-old"}]}
                                 if existing else {"SecurityGroups": []})
        if args[:2] == ["ec2", "describe-subnets"]:
            return 0, json.dumps({"Subnets": [
                {"SubnetId": "subnet-old",
                 "Tags": [{"Key": "Name",
                           "Value": "fleetflow-ap-northeast-1"}]}]}
                if existing else {"Subnets": []})
        if args[:2] == ["ec2", "create-security-group"]:
            return 0, json.dumps({"GroupId": "sg-9"})
        if args[:2] == ["ec2", "create-subnet"]:
            return 0, json.dumps({"Subnet": {"SubnetId": "subnet-9"}})
        if args[:2] == ["ec2", "run-instances"]:
            return 0, json.dumps({"Instances": [
                {"InstanceId": "i-9", "State": {"Name": "running"}}]})
        return 0, "{}"
    return runner


def case_aws_plan_includes_network_objects(P):
    calls = []
    p = P.aws.AwsProvider(runner=_aws_runner(calls, existing=False))
    decl = P.model.CloudProviderDecl(name="aws", options={
        "vpc": "vpc-1", "subnet-cidr": "10.0.2.0/24", "ingress": [22, 4510]})
    plan = p.plan(decl, [P.model.ServerResource(name="node-1",
                                                plan="small")])
    kinds = {(a.type.value, a.resource_type) for a in plan.actions}
    assert {("create", "security_group"), ("create", "subnet"),
            ("create", "server")} <= kinds
    res = p.apply(plan)
    assert res.ok, res.failed
    run = next(a for a in calls if a[:2] == ["ec2", "run-instances"])
    assert run[run.index("--subnet-id") + 1] == "subnet-9"
    assert run[run.index("--security-group-ids") + 1] == "sg-9"
    return calls, [sorted(kinds), res.outputs]


def case_aws_second_apply_wires_existing_network(P):
    calls = []
    p = P.aws.AwsProvider(runner=_aws_runner(calls, existing=True))
    decl = P.model.CloudProviderDecl(name="aws", options={
        "vpc": "vpc-1", "subnet-cidr": "10.0.2.0/24", "ingress": [22]})
    plan = p.plan(decl, [P.model.ServerResource(name="node-2")])
    assert {a.resource_type for a in plan.changes} == {"server"}
    res = p.apply(plan)
    assert res.ok, res.failed
    run = next(a for a in calls if a[:2] == ["ec2", "run-instances"])
    assert run[run.index("--subnet-id") + 1] == "subnet-old"
    assert run[run.index("--security-group-ids") + 1] == "sg-old"
    return calls, res.outputs


def case_missing_script_vars_fail_loudly(P):
    p = P.aws.AwsServerProvider(runner=lambda a: (0, "{}"))
    with pytest.raises(P.errors.CloudError, match="CP_ENDPOINT") as e:
        p.create_server(P.model.ServerResource(name="w1",
                                               startup_script="agent-setup"))
    return [], str(e.value)


def case_builtin_startup_scripts(P):
    s = P.scripts
    assert all(s.is_builtin_script(n) for n in ("docker-setup",
                                                 "agent-setup",
                                                 "worker-init"))
    assert not s.is_builtin_script("nope") and \
        s.get_builtin_script("nope") is None
    texts = {}
    for name in ("docker-setup", "agent-setup", "worker-init"):
        texts[name] = s.get_builtin_script(name)
        assert texts[name].startswith("#!/bin/bash")
        assert f"/var/lib/fleetflow/{name}.done" in texts[name]
    subst = s.substitute_vars(texts["agent-setup"], {
        "CP_ENDPOINT": "cp:4510", "SERVER_SLUG": "w1", "CA_PEM_B64": "Zm9v"})
    return [], [texts, subst]


def case_ssh_argv(P):
    calls = []

    def runner(args, timeout):
        calls.append([args, timeout])
        return 0, "out", ""
    target = P.ssh.SshTarget(host="1.2.3.4", user="ubuntu", key_path="/k")
    out = P.ssh.exec(target, "docker ps", runner=runner)
    assert out == "out"
    argv = calls[0][0]
    assert argv[0] == "ssh" and "ubuntu@1.2.3.4" in argv
    assert "-i" in argv and "BatchMode=yes" in " ".join(argv)
    out2 = P.ssh.exec_with_timeout(target, "uptime", timeout=7.0,
                                   runner=runner)
    P.ssh.copy_file(target, "/tmp/a", "/srv/a", runner=runner)
    with pytest.raises(P.errors.CloudError):
        P.ssh.exec(target, "false", runner=lambda a, t: (2, "", "no route"))
    return calls, [out, out2]


def _archive_runner(state, calls):
    def runner(args):
        calls.append(args)
        if args[:2] == ["archive", "list"]:
            return 0, json.dumps([
                {"ID": 111, "Name": "ubuntu-22.04", "SizeMB": 20480},
                {"ID": 222, "Name": "golden-fleet", "SizeMB": 40960}])
        if args[:2] == ["ssh-key", "list"]:
            return 0, json.dumps([{"ID": 31, "Name": "ops-key"}])
        if args[:2] == ["disk", "list"]:
            return 0, json.dumps([
                {"ID": 501, "SizeMB": 40 * 1024, "Server": {"ID": 900}},
                {"ID": 502, "SizeMB": 80 * 1024, "Server": {"ID": 901}}])
        if args[:2] == ["disk", "read"]:
            return 0, json.dumps([{"ID": int(args[2]),
                                   "SizeMB": 40 * 1024}])
        if args[:2] == ["disk", "update"]:
            state["resized"] = (args[2], args[args.index("--size") + 1])
            return 0, "{}"
        if args[:2] == ["server", "create"]:
            return 0, json.dumps([{"ID": "900", "Name": "w1"}])
        if args[:2] == ["server", "list"]:
            return 0, json.dumps([{"ID": 900, "Name": "w1",
                                   "InstanceStatus": "up",
                                   "Tags": ["fleet"]}])
        return 0, "[]"
    return runner


def case_archive_resolution_and_create(P):
    calls, state = [], {}
    p = P.sakura.SakuraServerProvider(runner=_archive_runner(state, calls))
    assert p.resolve_archive_id("123456") == "123456"
    assert p.resolve_archive_id("golden-fleet") == "222"
    with pytest.raises(P.errors.CloudError, match="archive not found"):
        p.resolve_archive_id("nope")
    info = p.create_server(P.model.ServerResource(
        name="w1", archive="golden-fleet", ssh_keys=["ops-key", "42"]))
    assert info.id == "900"
    create = next(a for a in calls if a[:2] == ["server", "create"])
    assert create[create.index("--disk-source-archive-id") + 1] == "222"
    assert "--os-type" not in create
    assert [create[j + 1] for j, a in enumerate(create)
            if a == "--ssh-key-ids"] == ["31", "42"]
    return calls, _plain(info)


def case_disk_grow_and_shrink_refused(P):
    calls, state = [], {}
    p = P.sakura.SakuraServerProvider(runner=_archive_runner(state, calls))
    disks = p.server_disks("900")
    assert disks == [{"id": "501", "size_gb": 40}]
    assert p.resize_disk("501", 100)
    assert state["resized"] == ("501", "100")
    with pytest.raises(P.errors.CloudError, match="cannot\\s+shrink"):
        p.resize_disk("501", 20)
    return calls, [disks, state]


def case_plan_emits_disk_resize_and_apply_runs_it(P):
    calls, state = [], {}
    p = P.sakura.SakuraProvider(runner=_archive_runner(state, calls))
    decl = P.provider.CloudProviderDecl(name="sakura")
    plan = p.plan(decl, [P.model.ServerResource(name="w1", disk_size=120)])
    resize = [a for a in plan.actions if a.resource_type == "disk"]
    assert len(resize) == 1 and "40gb -> 120gb" in resize[0].description
    res = p.apply(plan)
    assert not res.failed and state["resized"] == ("501", "120")
    first = list(calls)
    calls.clear()
    plan2 = p.plan(decl, [P.model.ServerResource(name="w1", disk_size=40)])
    assert all(a.type.value == "noop" for a in plan2.actions)
    assert sum(1 for a in calls if a[:2] == ["disk", "list"]) == 1
    return first + calls, [resize[0].description, state]


def case_shrink_surfaces_in_plan_and_apply_refuses(P):
    calls, state = [], {}
    p = P.sakura.SakuraProvider(runner=_archive_runner(state, calls))
    plan = p.plan(P.provider.CloudProviderDecl(name="sakura"),
                  [P.model.ServerResource(name="w1", disk_size=20)])
    shrink = [a for a in plan.actions if a.resource_type == "disk"]
    assert len(shrink) == 1 and "SHRINK" in shrink[0].description
    res = p.apply(plan)
    assert res.failed and "shrink" in res.failed[0][1]
    assert "resized" not in state
    return calls, [shrink[0].description, _plain(res.failed)]


def case_find_servers_by_tag(P):
    calls, state = [], {}
    p = P.sakura.SakuraServerProvider(runner=_archive_runner(state, calls))
    hit = [s.name for s in p.find_servers_by_tag("fleet")]
    assert hit == ["w1"] and p.find_servers_by_tag("other") == []
    return calls, hit


_TABLE = ("┌──────────────┬──────────────────────┐\n"
          "│ Project Name │ Project Domains      │\n"
          "├──────────────┼──────────────────────┤\n"
          "│ my-pages     │ my-pages.pages.dev   │\n"
          "└──────────────┴──────────────────────┘\n")


def case_pages_project_lifecycle(P):
    cf = P.cloudflare
    calls = []

    def runner(argv):
        calls.append(argv)
        if argv[:4] == ["wrangler", "pages", "project", "list"]:
            return 0, _TABLE
        return 0, "ok"
    projects = cf.pages_project_list(runner=runner)
    assert projects == [{"name": "my-pages",
                         "domains": "my-pages.pages.dev"}]
    assert cf.ensure_pages_project("my-pages", runner=runner) is False
    assert cf.ensure_pages_project("fresh", runner=runner) is True
    create = next(a for a in calls
                  if a[:4] == ["wrangler", "pages", "project", "create"])
    assert "fresh" in create and "--production-branch" in create
    cf.pages_project_create("x", production_branch="rel", runner=runner)
    assert calls[-1][-1] == "rel"
    cf.pages_project_delete("x", runner=runner)
    assert calls[-1][:4] == ["wrangler", "pages", "project", "delete"]
    assert "--yes" in calls[-1]
    return calls, projects


def case_r2_and_worker_management(P):
    cf = P.cloudflare
    calls = []

    def runner(argv):
        calls.append(argv)
        if argv[:4] == ["wrangler", "r2", "bucket", "list"]:
            return 0, "name: assets\ncreation_date: x\nname: media\n"
        return 0, "ok"
    buckets = cf.r2_bucket_list(runner=runner)
    assert buckets == ["assets", "media"]
    cf.r2_bucket_create("logs", runner=runner)
    assert calls[-1] == ["wrangler", "r2", "bucket", "create", "logs"]
    cf.r2_bucket_delete("logs", runner=runner)
    assert calls[-1] == ["wrangler", "r2", "bucket", "delete", "logs"]
    api = []

    def transport(method, path, body):
        api.append([method, path])
        return {"success": True,
                "result": [{"id": "edge-fn"}, {"id": "cron-fn"}]}
    workers = cf.worker_list("acct1", transport=transport)
    assert workers == ["edge-fn", "cron-fn"]
    assert api == [["GET", "/accounts/acct1/workers/scripts"]]
    cf.worker_delete("edge-fn", runner=runner)
    assert calls[-1] == ["wrangler", "delete", "--name", "edge-fn",
                         "--force"]
    return calls + api, [buckets, workers]


def case_failures_raise_loudly(P):
    cf = P.cloudflare
    bad = lambda argv: (1, "boom")  # noqa: E731
    msgs = []
    for fn in (cf.pages_project_create, cf.r2_bucket_create):
        with pytest.raises(P.errors.CloudError, match="create failed") as e:
            fn("x", runner=bad)
        msgs.append(str(e.value))
    return [], msgs


def case_archive_survives_serialize_roundtrip(P):
    flow = P.parser.parse_kdl_string('''
project "p"
service "a" { image "x" }
server "w1" { provider "sakura"; archive "golden-fleet"; disk-size 120 }
stage "live" { service "a"; servers "w1" }
''')
    assert flow.servers["w1"].archive == "golden-fleet"
    d = P.serialize.flow_to_dict(flow)
    flow2 = P.serialize.flow_from_dict(d)
    assert flow2.servers["w1"].archive == "golden-fleet"
    assert flow2.servers["w1"].disk_size == 120
    return [], d["servers"]


def case_multi_disk_server_targets_boot_disk_only(P):
    calls = []

    def runner(args):
        calls.append(args)
        if args[:2] == ["server", "list"]:
            return 0, json.dumps([{"ID": 900, "Name": "w1",
                                   "InstanceStatus": "up"}])
        if args[:2] == ["disk", "list"]:
            return 0, json.dumps([
                {"ID": 777, "SizeMB": 200 * 1024, "Server": {"ID": 900}},
                {"ID": 501, "SizeMB": 40 * 1024, "Server": {"ID": 900}}])
        return 0, "[]"
    p = P.sakura.SakuraProvider(runner=runner)
    decl = P.provider.CloudProviderDecl(name="sakura")
    plan = p.plan(decl, [P.model.ServerResource(name="w1", disk_size=40)])
    assert all(a.type.value == "noop" for a in plan.actions)
    plan2 = p.plan(decl, [P.model.ServerResource(name="w1", disk_size=80)])
    resize = [a for a in plan2.actions if a.resource_type == "disk"]
    assert len(resize) == 1 and resize[0].current["disk_id"] == "501"
    assert "resize 40gb -> 80gb" in resize[0].description
    return calls, [resize[0].description, resize[0].current]


_REGISTRY_SERVERS = '''
project "reg"
server "tokyo-1" { host "203.0.113.5"; ssh-user "deploy" }
server "osaka-1" { host "203.0.113.9" }
'''


def _registry(P):
    """tests/test_registry_build_cloud.py's "prod" registry, built from
    the model (its servers parsed by P's core parser)."""
    m = P.reg_model
    servers = P.parser.parse_kdl_string(_REGISTRY_SERVERS).servers
    return m.Registry(
        fleets={"shop": m.FleetEntry(name="shop", path="/srv/shop"),
                "blog": m.FleetEntry(name="blog", path="/srv/blog")},
        servers=dict(servers),
        routes=[m.DeploymentRoute(fleet="shop", stage="live",
                                  server="tokyo-1"),
                m.DeploymentRoute(fleet="blog", stage="live",
                                  server="osaka-1")])


def case_deploy_all_routes(P):
    calls = []

    def runner(args, timeout):
        calls.append(args)
        return 0, "deployment ok\n", ""
    results = P.registry.deploy_routes(_registry(P), runner=runner)
    assert [r.ok for r in results] == [True, True] and len(calls) == 2
    assert "deploy@203.0.113.5" in calls[0]
    assert calls[0][-1] == "cd /srv/shop && fleet deploy live -y"
    return calls, _plain(results)


def case_deploy_filter_and_failure(P):
    results = P.registry.deploy_routes(
        _registry(P), fleet="shop",
        runner=lambda a, t: (1, "", "remote fleet not installed"))
    assert len(results) == 1 and not results[0].ok
    assert "remote fleet not installed" in results[0].error
    return [], _plain(results)


def case_dry_run_runs_nothing(P):
    lines = []
    results = P.registry.deploy_routes(
        _registry(P), dry_run=True,
        runner=lambda a, t: (_ for _ in ()).throw(
            AssertionError("must not run")),
        on_line=lines.append)
    assert all(r.ok for r in results) and len(lines) == 2
    return [], [lines, _plain(results)]


def case_sync_payloads(P):
    payloads = P.registry.sync_servers_payloads(_registry(P))
    assert [p["slug"] for p in payloads] == ["osaka-1", "tokyo-1"]
    assert payloads[1]["hostname"] == "203.0.113.5"
    remote = P.reg_deploy.remote_deploy_cmd("/srv/a b", "live")
    return [], [payloads, remote]


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}
_TMP = {"state_tree_persistence"}


def _run(P, name, tmp_path):
    fn = CASES[name]
    return fn(P, tmp_path / P.name) if name in _TMP else fn(P)


@pytest.mark.parametrize("P", BOTH, ids=["ref", "port"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_case(P, name, tmp_path):
    """The reference test's contract on package P."""
    _run(P, name, tmp_path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_commands_and_results(name, tmp_path):
    """The same fake runner or transport sees the same command lines and
    REST calls from both packages, and each returns the same."""
    ref_calls, ref_out = _run(REF, name, tmp_path)
    port_calls, port_out = _run(PORT, name, tmp_path)
    assert port_calls == ref_calls
    assert _plain(port_out) == _plain(ref_out)


def test_registration_at_import():
    """cloud/__init__ registers sakura, cloudflare and aws, as the
    reference's does, each under the reference's class name."""
    for name in ("sakura", "cloudflare", "aws"):
        assert type(PORT.cloud.get_provider(name)).__name__ == \
            type(REF.cloud.get_provider(name)).__name__
    assert PORT.registry.__all__ == ["Registry", "FleetEntry",
                                     "DeploymentRoute", "RouteResult",
                                     "deploy_routes",
                                     "sync_servers_payloads"]
