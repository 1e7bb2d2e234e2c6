"""KDL → Flow parser.

Python analog of crates/fleetflow-core/src/parser/ (mod.rs top-level dispatch,
service.rs, stage.rs, port.rs, volume.rs, cloud.rs, tenant.rs). Accepts the
same configuration language the reference parses:

    project "name"
    provider "sakura-cloud" { zone "tk1a" }
    server "cp-1" { provider "..." plan "2core-4gb" ... }
    service "db" { image "..." ports { port host=5432 container=5432 } ... }
    stage "live" { server "cp-1"; service "db" { ...overrides... } }
    variables { KEY "value" }
    include "services/*.kdl"
    registry "ghcr.io/org"
    tenant "acme"

Top-level service redefinition merges onto the existing definition
(reference: parser/mod.rs:184-299); per-stage service nodes become overrides
merged at resolve time (model.Stage.resolved_services).

The port's copy of ``fleetflow_tpu/core/parser.py``: the same text parses to
a Flow that serializes (core/serialize.py) to the same dict.
"""

from __future__ import annotations

import glob as globmod
import os
from typing import Any, Optional

from .errors import FlowError
from .kdl import KdlNode, bool_value, parse_document
from .model import (
    Backend, BuildConfig, CloudProviderDecl, DeployConfig, FallbackPolicy, Flow,
    HealthCheck, PlacementPolicy, PlacementStrategy, Port, Protocol,
    ReadinessCheck, RegistryRef, ResourceQuota, ResourceSpec, RestartPolicy,
    ServerLabels, ServerResource, Service, ServiceType, SourceLoc,
    SpreadConstraint, Stage, TenantSpec, Volume, WaitConfig,
)

__all__ = [
    "parse_kdl_string", "parse_kdl_file", "read_kdl_with_includes",
    "include_patterns_of_line", "resolve_include_pattern",
    "parse_service", "parse_stage", "parse_provider", "parse_server",
    "parse_port", "parse_volume", "parse_tenant",
]


def _as_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


# one shared definition (core.kdl.bool_value): bare-word false must
# never coerce truthy anywhere config is read
_as_bool = bool_value


def _loc(node: KdlNode, source: Optional[str] = None) -> Optional[SourceLoc]:
    """Node span → model SourceLoc (None when the parse carried no spans,
    e.g. the native fast path or programmatic nodes)."""
    if not node.line:
        return None
    return SourceLoc(line=node.line, col=node.col, file=source)


def _str_args(node: KdlNode) -> list[str]:
    return [_as_str(a) for a in node.args if a is not None]


def _env_from_children(node: KdlNode) -> dict[str, str]:
    """`env { KEY "value" }` or `environment { ... }` blocks; also accepts
    `KEY=value` props on the block node. An explicit `null` value maps to
    the empty string (unset-ish), not the literal "None"."""
    out: dict[str, str] = {}
    for k, v in node.props.items():
        out[k] = "" if v is None else _as_str(v)
    for child in node.children:
        v = child.arg(0, "")
        out[child.name] = "" if v is None else _as_str(v)
    return out


def _duration(v: Any, default: float) -> float:
    """Seconds from number or '30s'/'5m'/'1h' strings."""
    if v is None:
        return default
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    s = str(v).strip().lower()
    mult = 1.0
    if s.endswith("ms"):
        mult, s = 0.001, s[:-2]
    elif s.endswith("s"):
        mult, s = 1.0, s[:-1]
    elif s.endswith("m"):
        mult, s = 60.0, s[:-1]
    elif s.endswith("h"):
        mult, s = 3600.0, s[:-1]
    try:
        return float(s) * mult
    except ValueError:
        raise FlowError(f"bad duration {v!r}") from None


# --------------------------------------------------------------------------
# Leaf parsers (port.rs, volume.rs)
# --------------------------------------------------------------------------

def parse_port(node: KdlNode, source: Optional[str] = None) -> Port:
    """`port host=8080 container=80 protocol="udp" host-ip="127.0.0.1"`,
    positional `port 8080 80`, or the compose-style string
    `port "8080:80[/udp]"` / `port "127.0.0.1:8080:80"`
    (reference: parser/port.rs)."""
    host = node.prop("host", node.arg(0))
    container = node.prop("container", node.arg(1, host))
    proto = node.prop("protocol", node.prop("proto", "tcp"))
    host_ip = node.prop("host-ip", node.prop("host_ip"))
    if isinstance(host, str) and ":" in host:
        # docker-compose shorthand in one string
        spec = host
        if "/" in spec:
            spec, proto = spec.rsplit("/", 1)
        parts = spec.split(":")
        if len(parts) == 2:
            host, container = parts
        elif len(parts) == 3:
            host_ip, host, container = parts
        else:
            raise FlowError(f"cannot parse port spec {host!r} "
                            f"(want host:container[/proto])")
    if host is None:
        raise FlowError(f"port node missing host port: {node}")
    try:
        return Port(host=int(host), container=int(container),
                    protocol=Protocol.parse(_as_str(proto)),
                    host_ip=host_ip if host_ip is None else _as_str(host_ip),
                    loc=_loc(node, source))
    except (TypeError, ValueError) as e:
        raise FlowError(f"invalid port node {node}: {e}") from None


def parse_volume(node: KdlNode, source: Optional[str] = None) -> Volume:
    """`volume "./host" "/container" read-only=true` (reference: parser/volume.rs)."""
    args = _str_args(node)
    if not args:
        raise FlowError("volume node needs at least a host path")
    host = args[0]
    container = args[1] if len(args) > 1 else host
    ro = _as_bool(node.prop("read-only",
                       node.prop("read_only", node.prop("ro", False))),
                  node)
    return Volume(host=host, container=container, read_only=ro,
                  loc=_loc(node, source))


# --------------------------------------------------------------------------
# Service parser (service.rs)
# --------------------------------------------------------------------------

def _parse_build(node: KdlNode) -> BuildConfig:
    b = BuildConfig()
    if node.args:
        b.context = _as_str(node.arg(0))
    for c in node.children:
        if c.name == "context":
            b.context = c.first_string(".")
        elif c.name == "dockerfile":
            b.dockerfile = c.first_string()
        elif c.name in ("args", "build_args", "build-args"):
            b.args = _env_from_children(c)
        elif c.name == "target":
            b.target = c.first_string()
        elif c.name in ("no_cache", "no-cache"):
            b.no_cache = _as_bool(c.arg(0, True), c)
        elif c.name in ("image_tag", "image-tag", "tag"):
            b.image_tag = c.first_string()
    for k, v in node.props.items():
        if k == "context":
            b.context = _as_str(v)
        elif k == "dockerfile":
            b.dockerfile = _as_str(v)
        elif k == "target":
            b.target = _as_str(v)
    return b


def _parse_deploy(node: KdlNode) -> DeployConfig:
    d = DeployConfig()
    if node.args:
        d.type = _as_str(node.arg(0))
    for c in node.children:
        # "provider" is the reference's spelling (service.rs:129-141);
        # accept both so configs port over unchanged
        if c.name in ("type", "provider"):
            d.type = c.first_string(d.type)
        elif c.name == "output":
            d.output = c.first_string()
        elif c.name == "command":
            d.command = c.first_string()
        elif c.name == "project":
            d.project = c.first_string()
    for k, v in node.props.items():
        # reference KDL uses property form: deploy provider="..." output="..."
        if k in ("type", "provider"):
            d.type = _as_str(v)
        elif k == "output":
            d.output = _as_str(v)
        elif k == "command":
            d.command = _as_str(v)
        elif k == "project":
            d.project = _as_str(v)
    return d


def _parse_healthcheck(node: KdlNode) -> HealthCheck:
    h = HealthCheck()
    if node.args:
        h.test = _str_args(node)
    for c in node.children:
        if c.name in ("test", "command"):
            h.test = _str_args(c)
        elif c.name == "interval":
            h.interval = _duration(c.arg(0), h.interval)
        elif c.name == "timeout":
            h.timeout = _duration(c.arg(0), h.timeout)
        elif c.name == "retries":
            h.retries = int(c.arg(0, h.retries))
        elif c.name in ("start_period", "start-period"):
            h.start_period = _duration(c.arg(0), h.start_period)
    # reference KDL is property-style (service.rs:236-269): healthcheck
    # test="..." interval=15 ... — dropping these silently kept defaults
    for k, v in node.props.items():
        if k in ("test", "command"):
            h.test = [_as_str(v)]
        elif k == "interval":
            h.interval = _duration(v, h.interval)
        elif k == "timeout":
            h.timeout = _duration(v, h.timeout)
        elif k == "retries":
            h.retries = int(v)
        elif k in ("start_period", "start-period"):
            h.start_period = _duration(v, h.start_period)
    return h


def _parse_readiness(node: KdlNode) -> ReadinessCheck:
    r = ReadinessCheck()
    for c in node.children:
        if c.name == "type":
            r.type = c.first_string(r.type)
        elif c.name == "path":
            r.path = c.first_string(r.path)
        elif c.name == "port":
            r.port = int(c.arg(0)) if c.arg(0) is not None else None
        elif c.name == "timeout":
            r.timeout = _duration(c.arg(0), r.timeout)
        elif c.name == "interval":
            r.interval = _duration(c.arg(0), r.interval)
    for k, v in node.props.items():
        if k == "path":
            r.path = _as_str(v)
        elif k == "port":
            r.port = int(v)
        elif k == "type":
            r.type = _as_str(v)
        elif k == "timeout":
            r.timeout = _duration(v, r.timeout)
        elif k == "interval":
            r.interval = _duration(v, r.interval)
    return r


def _parse_wait(node: KdlNode) -> WaitConfig:
    w = WaitConfig()
    for c in node.children:
        if c.name in ("max_retries", "max-retries", "retries"):
            w.max_retries = int(c.arg(0, w.max_retries))
        elif c.name in ("initial_delay", "initial-delay"):
            w.initial_delay = _duration(c.arg(0), w.initial_delay)
        elif c.name in ("max_delay", "max-delay"):
            w.max_delay = _duration(c.arg(0), w.max_delay)
        elif c.name == "multiplier":
            w.multiplier = float(c.arg(0, w.multiplier))
    for k, v in node.props.items():
        if k in ("max_retries", "max-retries", "retries"):
            w.max_retries = int(v)
        elif k in ("initial_delay", "initial-delay"):
            w.initial_delay = _duration(v, w.initial_delay)
        elif k in ("max_delay", "max-delay"):
            w.max_delay = _duration(v, w.max_delay)
        elif k == "multiplier":
            w.multiplier = float(v)
    return w


def _parse_resources(node: KdlNode) -> ResourceSpec:
    r = ResourceSpec()
    for c in node.children:
        if c.name == "cpu":
            r.cpu = float(c.arg(0, r.cpu))
        elif c.name in ("memory", "mem"):
            r.memory = _mem_mb(c.arg(0, r.memory))
        elif c.name == "disk":
            r.disk = _mem_mb(c.arg(0, r.disk))
    for k, v in node.props.items():
        if k == "cpu":
            r.cpu = float(v)
        elif k in ("memory", "mem"):
            r.memory = _mem_mb(v)
        elif k == "disk":
            r.disk = _mem_mb(v)
    return r


def _mem_mb(v: Any) -> float:
    """MiB from number or '512m'/'2g'/'1t' strings."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    s = str(v).strip().lower()
    for suffix, mult in (("gib", 1024.0), ("gb", 1024.0), ("g", 1024.0),
                         ("mib", 1.0), ("mb", 1.0), ("m", 1.0),
                         ("tib", 1024.0 * 1024), ("tb", 1024.0 * 1024), ("t", 1024.0 * 1024),
                         ("kib", 1 / 1024.0), ("kb", 1 / 1024.0), ("k", 1 / 1024.0)):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    return float(s)


def parse_service(node: KdlNode, source: Optional[str] = None) -> Service:
    """Parse a `service "name" { ... }` node (reference: parser/service.rs)."""
    name = node.first_string()
    if not name:
        raise FlowError("service node requires a name argument")
    svc = Service(name=name, loc=_loc(node, source))
    for k, v in node.props.items():
        if k == "image":
            svc.image = _as_str(v)
        elif k == "version":
            svc.version = _as_str(v)
        elif k == "type":
            svc.service_type = ServiceType(_as_str(v))
        elif k == "command":
            svc.command = _as_str(v)
        elif k == "restart":
            svc.restart = RestartPolicy.parse(_as_str(v))
        elif k == "registry":
            svc.registry = _as_str(v)
    for c in node.children:
        n = c.name
        if n == "image":
            svc.image = c.first_string()
        elif n == "version":
            svc.version = _as_str(c.arg(0, ""))
        elif n == "command":
            args = _str_args(c)
            svc.command = " ".join(args) if args else None
        elif n == "restart":
            svc.restart = RestartPolicy.parse(c.first_string("no"))
        elif n in ("service_type", "service-type", "type"):
            svc.service_type = ServiceType(c.first_string("container"))
        elif n == "registry":
            svc.registry = c.first_string()
        elif n == "ports":
            svc.ports = [parse_port(p, source) for p in c.children_named("port")]
        elif n == "port":
            svc.ports.append(parse_port(c, source))
        elif n == "volumes":
            svc.volumes = [parse_volume(v, source)
                           for v in c.children_named("volume")]
        elif n == "volume":
            svc.volumes.append(parse_volume(c, source))
        elif n in ("env", "environment"):
            svc.environment.update(_env_from_children(c))
        elif n == "depends_on" or n == "depends-on":
            targets = _str_args(c)
            svc.depends_on.extend(targets)
            dloc = _loc(c, source)
            if dloc is not None:
                for t in targets:
                    svc.dep_locs.setdefault(t, dloc)
        elif n == "build":
            svc.build = _parse_build(c)
        elif n == "deploy":
            svc.deploy = _parse_deploy(c)
        elif n == "healthcheck":
            svc.healthcheck = _parse_healthcheck(c)
        elif n in ("readiness", "readiness_check", "readiness-check"):
            svc.readiness = _parse_readiness(c)
        elif n in ("wait", "wait_for", "wait-for"):
            svc.wait = _parse_wait(c)
        elif n == "variables":
            svc.variables.update(_env_from_children(c))
        elif n == "resources":
            svc.resources = _parse_resources(c)
            svc._resources_set = True
        elif n == "labels":
            svc.labels.update(_env_from_children(c))
        elif n in ("colocate_with", "colocate-with"):
            svc.colocate_with.extend(_str_args(c))
        elif n in ("anti_affinity", "anti-affinity"):
            svc.anti_affinity.extend(_str_args(c))
        elif n == "replicas":
            svc.replicas = int(c.arg(0, 1))
            svc._replicas_set = True
    return svc


# --------------------------------------------------------------------------
# Stage parser (stage.rs)
# --------------------------------------------------------------------------

def _parse_quota(node: KdlNode) -> ResourceQuota:
    q = ResourceQuota()
    for c in node.children:
        if c.name == "cpu":
            q.cpu = float(c.arg(0))
        elif c.name in ("memory", "mem"):
            q.memory = _mem_mb(c.arg(0))
        elif c.name == "disk":
            q.disk = _mem_mb(c.arg(0))
        elif c.name in ("max-services", "max_services"):
            q.max_services = int(c.arg(0))
    return q


def _parse_placement(node: KdlNode) -> PlacementPolicy:
    p = PlacementPolicy()
    if node.args:
        p.strategy = PlacementStrategy.parse(_as_str(node.arg(0)))
    for c in node.children:
        if c.name == "strategy":
            p.strategy = PlacementStrategy.parse(c.first_string("spread_across_pool"))
        elif c.name == "tier":
            p.tier = c.first_string()
        elif c.name in ("preferred_labels", "preferred-labels"):
            p.preferred_labels = _env_from_children(c)
        elif c.name in ("required_labels", "required-labels"):
            p.required_labels = _env_from_children(c)
        elif c.name in ("resource_quota", "resource-quota", "quota"):
            p.resource_quota = _parse_quota(c)
        elif c.name in ("spread", "spread_constraint", "spread-constraint"):
            p.spread_constraint = SpreadConstraint(
                topology_key=_as_str(c.prop("topology_key",
                                            c.prop("topology-key", c.arg(0, "node")))),
                max_skew=int(c.prop("max_skew", c.prop("max-skew", 1))))
        elif c.name in ("fallback", "fallback_policy", "fallback-policy"):
            p.fallback_policy = FallbackPolicy(relax_order=_str_args(c)
                                               or FallbackPolicy().relax_order)
        elif c.name == "streaming":
            # `streaming #true` — the stage feeds deploy.submit (the
            # continuous-arrival path); lint FF015 keys on this
            p.streaming = _as_bool(c.arg(0, True), c)
    return p


def parse_stage(node: KdlNode, source: Optional[str] = None) -> Stage:
    """Parse a `stage "name" { ... }` node (reference: parser/stage.rs)."""
    name = node.first_string()
    if not name:
        raise FlowError("stage node requires a name argument")
    st = Stage(name=name, loc=_loc(node, source))
    seen = set()   # dedup via set: `in st.services` is O(n) and a
    for c in node.children:                # 10k-service stage paid O(n^2)
        if c.name == "service":
            sname = c.first_string()
            if not sname:
                raise FlowError(f"stage {name!r}: service node requires a name")
            if sname not in seen:
                seen.add(sname)
                st.services.append(sname)
                cloc = _loc(c, source)
                if cloc is not None:
                    st.service_locs[sname] = cloc
            if c.children or c.props:
                st.service_overrides[sname] = parse_service(c, source)
        elif c.name in ("server", "servers"):
            names = _str_args(c)
            st.servers.extend(names)
            cloc = _loc(c, source)
            if cloc is not None:
                for sv in names:
                    st.server_locs.setdefault(sv, cloc)
        elif c.name == "variables":
            st.variables.update(_env_from_children(c))
        elif c.name == "registry":
            st.registry = c.first_string()
        elif c.name == "backend":
            st.backend = Backend.parse(c.first_string("docker"))
        elif c.name == "placement":
            st.placement = _parse_placement(c)
    return st


# --------------------------------------------------------------------------
# Cloud parsers (cloud.rs)
# --------------------------------------------------------------------------

def parse_provider(node: KdlNode) -> CloudProviderDecl:
    name = node.first_string()
    if not name:
        raise FlowError("provider node requires a name argument")
    p = CloudProviderDecl(name=name)
    for c in node.children:
        if c.name == "zone":
            p.zone = c.first_string()
        else:
            p.options[c.name] = c.arg(0) if len(c.args) <= 1 else list(c.args)
    # reference KDL is property-style (cloud.rs:10-18): `provider "sakura"
    # zone="tk1a"` — zone must land on the field, not in options
    for k, v in node.props.items():
        if k == "zone":
            p.zone = _as_str(v)
        else:
            p.options[k] = v
    return p


def _parse_server_labels(node: KdlNode) -> ServerLabels:
    lbl = ServerLabels()
    d = _env_from_children(node)
    lbl.tier = d.pop("tier", None)
    lbl.region = d.pop("region", None)
    lbl.clazz = d.pop("class", None)
    lbl.arch = d.pop("arch", None)
    lbl.extra = d
    return lbl


def parse_server(node: KdlNode, source: Optional[str] = None) -> ServerResource:
    """Parse a `server "name" { ... }` node (reference: parser/cloud.rs)."""
    name = node.first_string()
    if not name:
        raise FlowError("server node requires a name argument")
    s = ServerResource(name=name, loc=_loc(node, source))
    for c in node.children:
        n = c.name.replace("_", "-")
        if n == "provider":
            s.provider = c.first_string()
        elif n == "plan":
            s.plan = c.first_string()
        elif n == "disk-size":
            s.disk_size = int(c.arg(0, 0))
        elif n == "os":
            s.os = c.first_string()
        elif n == "archive":
            s.archive = c.first_string()
        elif n in ("ssh-key", "ssh-keys"):
            s.ssh_keys.extend(_str_args(c))
        elif n in ("ssh-host", "host"):
            s.ssh_host = c.first_string()
        elif n == "ssh-user":
            s.ssh_user = c.first_string()
        elif n == "tags":
            s.tags.extend(_str_args(c))
        elif n == "startup-script":
            s.startup_script = c.first_string()
        elif n == "dns":
            for d in c.children:
                if d.name == "hostname":
                    s.dns_hostname = d.first_string()
                elif d.name in ("alias", "aliases"):
                    s.dns_aliases.extend(_str_args(d))
        elif n in ("dns-hostname",):
            s.dns_hostname = c.first_string()
        elif n in ("dns-alias", "dns-aliases"):
            s.dns_aliases.extend(_str_args(c))
        elif n == "capacity":
            s.capacity = _parse_resources(c)
        elif n == "labels":
            s.labels = _parse_server_labels(c)
    # reference KDL is property-style throughout its server decls
    # (cloud.rs:23-69): `server "web-1" provider="sakura" plan="2core-4gb"
    # disk-size=40 ...` — dropping these silently lost the whole inventory
    for k, v in node.props.items():
        kk = k.replace("_", "-")
        if kk == "provider":
            s.provider = _as_str(v)
        elif kk == "plan":
            s.plan = _as_str(v)
        elif kk == "disk-size":
            s.disk_size = int(v)
        elif kk == "os":
            s.os = _as_str(v)
        elif kk == "archive":
            s.archive = _as_str(v)
        elif kk in ("ssh-key", "ssh-keys"):
            s.ssh_keys.append(_as_str(v))
        elif kk in ("ssh-host", "host"):
            s.ssh_host = _as_str(v)
        elif kk == "ssh-user":
            s.ssh_user = _as_str(v)
        elif kk == "startup-script":
            s.startup_script = _as_str(v)
        elif kk == "dns-hostname":
            s.dns_hostname = _as_str(v)
    return s


def parse_tenant(node: KdlNode) -> TenantSpec:
    name = node.first_string()
    if not name:
        raise FlowError("tenant node requires a name argument")
    t = TenantSpec(name=name)
    for c in node.children:
        if c.name in ("display_name", "display-name"):
            t.display_name = c.first_string()
        else:
            t.options[c.name] = c.arg(0)
    return t


# --------------------------------------------------------------------------
# Top-level dispatch (mod.rs)
# --------------------------------------------------------------------------

def _merge_stage_into(old: Stage, st: Stage) -> None:
    """Stage redefinition: merge `st` onto `old` (reads `st`, mutates
    `old` — the dispatch's historical in-place semantics)."""
    have = set(old.services)   # O(n^2) scan at fleet scale
    for sname in st.services:
        if sname not in have:
            have.add(sname)
            old.services.append(sname)
    for sname, ov in st.service_overrides.items():
        if sname in old.service_overrides:
            old.service_overrides[sname] = \
                old.service_overrides[sname].merge(ov)
        else:
            old.service_overrides[sname] = ov
    old.servers = st.servers or old.servers
    old.service_locs.update(st.service_locs)
    old.server_locs.update(st.server_locs)
    old.variables.update(st.variables)
    old.registry = st.registry or old.registry
    if st.backend != Backend.DOCKER:
        old.backend = st.backend
    old.placement = st.placement or old.placement


def _stage_copy(st: Stage) -> Stage:
    """Stage with fresh top-level containers (shared Service/loc leaves) —
    later redefinition merges mutate the copy, never a cached fragment."""
    return Stage(name=st.name, services=list(st.services),
                 service_overrides=dict(st.service_overrides),
                 servers=list(st.servers), variables=dict(st.variables),
                 registry=st.registry, backend=st.backend,
                 placement=st.placement, loc=st.loc,
                 service_locs=dict(st.service_locs),
                 server_locs=dict(st.server_locs))


def merge_flow_fragment(flow: Flow, frag: Flow) -> Flow:
    """Merge a parsed fragment onto `flow` with the semantics of running
    the top-level dispatch over the fragment's source text. Reads the
    fragment only — cached fragments stay immutable; mutable containers
    that later merges write into (stages, service entries) are copied in.
    """
    if frag.name != "unnamed":
        flow.name = frag.name
    for svc in frag.services.values():
        flow.merge_service(svc.shallow_copy())
    flow.redefinitions.extend(frag.redefinitions)
    for st in frag.stages.values():
        old = flow.stages.get(st.name)
        if old is not None:
            _merge_stage_into(old, st)
        else:
            flow.stages[st.name] = _stage_copy(st)
    flow.providers.update(frag.providers)
    flow.servers.update(frag.servers)
    flow.variables.update(frag.variables)
    for k, v in frag.variable_locs.items():
        flow.variable_locs.setdefault(k, v)
    if frag.registry is not None:
        flow.registry = frag.registry
    if frag.tenant is not None:
        flow.tenant = frag.tenant
    return flow


def _thaw_fragment(frag: Flow) -> Flow:
    """A caller-owned view of a cached fragment: fresh top-level
    containers, shallow-copied services, copied stages. Nested leaf
    containers (ports, env dicts, ...) stay shared under the established
    read-only contract (model.Stage.resolved_services docstring)."""
    return Flow(
        name=frag.name,
        services={k: v.shallow_copy() for k, v in frag.services.items()},
        stages={k: _stage_copy(v) for k, v in frag.stages.items()},
        providers=dict(frag.providers),
        servers=dict(frag.servers),
        registry=frag.registry,
        variables=dict(frag.variables),
        tenant=frag.tenant,
        variable_locs=dict(frag.variable_locs),
        redefinitions=list(frag.redefinitions),
    )


def _parse_kdl_fragment(text: str, *, want_spans: bool = False,
                        source: Optional[str] = None,
                        line_offset: int = 0) -> Flow:
    """The uncached parse: KDL text -> a fresh Flow fragment."""
    flow = Flow()
    try:
        nodes = parse_document(text, want_spans=want_spans,
                               line_offset=line_offset)
    except Exception as e:
        raise FlowError(f"KDL parse failed: {e}") from e

    for node in nodes:
        n = node.name
        if n == "project":
            flow.name = node.first_string(flow.name)
        elif n == "service":
            flow.merge_service(parse_service(node, source))
        elif n == "stage":
            st = parse_stage(node, source)
            if st.name in flow.stages:
                _merge_stage_into(flow.stages[st.name], st)
            else:
                flow.stages[st.name] = st
        elif n == "provider":
            p = parse_provider(node)
            flow.providers[p.name] = p
        elif n == "server":
            s = parse_server(node, source)
            flow.servers[s.name] = s
        elif n == "variables":
            flow.variables.update(_env_from_children(node))
            for c in node.children:
                vloc = _loc(c, source)
                if vloc is not None:
                    flow.variable_locs.setdefault(c.name, vloc)
        elif n == "registry":
            flow.registry = RegistryRef(url=node.first_string(""),
                                        username=node.prop("username"))
        elif n == "tenant":
            flow.tenant = parse_tenant(node)
        elif n == "include":
            raise FlowError(
                "include nodes must be expanded before parsing "
                "(use read_kdl_with_includes)")
        # unknown top-level nodes are ignored (forward compat), matching the
        # reference's lenient dispatch
    return flow


def _cache_min_bytes() -> int:
    from .parsecache import _env_int
    return _env_int("FLEET_PARSE_CACHE_MIN", 2048)


def parse_kdl_string(text: str, flow: Optional[Flow] = None, *,
                     want_spans: bool = False,
                     source: Optional[str] = None,
                     line_offset: int = 0,
                     cache: Optional[bool] = None) -> Flow:
    """Parse KDL text into (or onto) a Flow.

    Reference: parser/mod.rs:160,184-299. Top-level nodes: project / stage /
    service / provider / server / variables / registry / tenant / include
    (include must be resolved beforehand via read_kdl_with_includes; a
    leftover include node raises). Service redefinition merges; stage
    redefinition merges service lists/overrides. Stage selection happens at
    load time (template pre-pass) and resolve time (Stage.resolved_services),
    not at parse time.

    ``want_spans=True`` forces the span-carrying pure-Python KDL parser so
    model objects get SourceLoc positions (the `fleet lint` path); ``source``
    labels those locations with a file name (single-file parses — multi-file
    concatenations resolve lines through the lint SourceMap instead).
    ``line_offset`` shifts every span/error line by a constant so per-file
    fragment parses keep concatenation coordinates.

    Parses are served from the content-addressed parse cache
    (core/parsecache.py) keyed on sha256 of the text: ``cache=None`` (auto)
    caches texts >= FLEET_PARSE_CACHE_MIN bytes, ``cache=True``/``False``
    force. Cached fragments are immutable; callers get a thawed copy (or a
    fragment merge when ``flow`` is passed), sharing leaf objects under the
    read-only contract.
    """
    if cache is None:
        cache = len(text) >= _cache_min_bytes()
    if not cache:
        frag = _parse_kdl_fragment(text, want_spans=want_spans,
                                   source=source, line_offset=line_offset)
        if flow is None:
            return frag
        return merge_flow_fragment(flow, frag)

    from .parsecache import default_parse_cache
    pc = default_parse_cache()
    key = pc.key(text, want_spans, source, line_offset)
    frag = pc.get(key)
    if frag is None:
        frag = _parse_kdl_fragment(text, want_spans=want_spans,
                                   source=source, line_offset=line_offset)
        pc.put(key, frag)
    if flow is None:
        return _thaw_fragment(frag)
    return merge_flow_fragment(flow, frag)


def include_patterns_of_line(stripped: str) -> Optional[list[str]]:
    """The include-glob patterns when `stripped` is an `include` node
    line, else None. THE one definition of the include line discipline —
    shared by the loader's expansion (`_read_expanded`) and the cache
    hashes' include scanner (registry/aggregate.py), so what invalidates
    a cache can never drift from what a load actually reads."""
    if not (stripped.startswith("include ") or stripped == "include"):
        return None
    try:
        nodes = parse_document(stripped)
    except Exception:
        return None
    if not nodes or nodes[0].name != "include":
        return None
    return [str(a) for a in nodes[0].args]


def resolve_include_pattern(pat: str, base: str) -> tuple[list[str], str]:
    """(sorted on-disk matches, resolved pattern) for one include glob
    against `base` — the shared resolution rule (absolute patterns stand,
    relative ones join the including file's real directory)."""
    full = pat if os.path.isabs(pat) else os.path.join(base, pat)
    return sorted(globmod.glob(full)), full


def _read_expanded(path: str, seen: set[str]
                   ) -> tuple[list[str], list[tuple[int, int, str, int]]]:
    """Recursive include expansion with segment tracking.

    Returns (output lines, segments), each segment being
    ``(start index in the output lines (0-based), line count, source path,
    1-based first line of the run IN that source file)`` — the raw material
    for the lint SourceMap, so a diagnostic below an `include` still points
    at its true on-disk line instead of drifting by the expansion's size.
    """
    real = os.path.realpath(path)
    if real in seen:
        raise FlowError(f"include cycle detected at {path}")
    seen.add(real)
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise FlowError(f"cannot read {path}: {e}") from e

    base = os.path.dirname(real)
    out: list[str] = []
    segs: list[tuple[int, int, str, int]] = []
    run_out = 0     # output index where the current run of own lines began
    run_src = 1     # 1-based source line where that run began

    def flush(next_src_line: int) -> None:
        nonlocal run_out, run_src
        if len(out) > run_out:
            segs.append((run_out, len(out) - run_out, path, run_src))
        run_out, run_src = len(out), next_src_line

    for i, line in enumerate(text.splitlines()):
        patterns = include_patterns_of_line(line.strip())
        if patterns is not None:
            flush(i + 2)    # the include line itself emits nothing
            for pat in patterns:
                matches, full = resolve_include_pattern(pat, base)
                if not matches and not globmod.has_magic(full):
                    raise FlowError(f"include target not found: {pat}")
                for m in matches:
                    sub_lines, sub_segs = _read_expanded(m, seen)
                    offset = len(out)
                    segs.extend((offset + s, n, p, ls)
                                for s, n, p, ls in sub_segs)
                    out.extend(sub_lines)
            run_out = len(out)
            continue
        out.append(line)
    flush(0)
    return out, segs


def read_kdl_with_includes(path: str, _seen: Optional[set[str]] = None,
                           segments: Optional[list] = None) -> str:
    """Read a KDL file, expanding `include "glob"` nodes inline with cycle
    detection (reference: parser/mod.rs:54). Pass a ``segments`` list to
    receive ``(1-based start line in the returned text, line count, source
    path, 1-based start line in that file)`` tuples mapping the expanded
    text back to the files it came from (the lint SourceMap input)."""
    lines, segs = _read_expanded(path, _seen if _seen is not None else set())
    if segments is not None:
        segments.extend((s + 1, n, p, ls) for s, n, p, ls in segs)
    return "\n".join(lines)


def parse_kdl_file(path: str) -> Flow:
    """Load + include-expand + parse one KDL file (reference: parser/mod.rs:31)."""
    return parse_kdl_string(read_kdl_with_includes(path))
