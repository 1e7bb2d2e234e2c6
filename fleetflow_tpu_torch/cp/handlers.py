"""Channel handlers: the CP's RPC surface (the port's copy of
``fleetflow_tpu/cp/handlers.py``).

Analog of controlplane handlers/ (13 channels, handlers/mod.rs:21-35), all
shaped `method -> store/registry op -> payload`. The agent channel is the
duplex session (handlers/agent.rs): register-first enforcement, heartbeat /
alert / log / command_result events, CP->agent commands via AgentRegistry.

Every handler is a closure over AppState; `register_all` wires them into the
ProtocolServer. The placement channel, `deploy.execute` and `deploy.submit`
reach the card through the state's PlacementService: each solve runs in an
executor thread (on the card's current stream) so a fleet-scale solve does
not stall the loop. A handler that raises — a device fault included —
answers its RPC with an error naming the exception's type and counts
`fleet_cp_request_errors_total`; no handler turns a fault of the device
path into a degraded success.
"""

from __future__ import annotations

import asyncio
import time
from typing import TYPE_CHECKING

from ..core.serialize import flow_from_dict
from ..obs import get_logger, span
from ..obs.metrics import REGISTRY
from ..obs.trace import new_trace_id, use_trace
from ..runtime.engine import DeployEngine, DeployRequest
from .agent_registry import BUILD_TIMEOUT, DEPLOY_TIMEOUT
from .log_router import LogEntry, topic_for
from .models import (BuildJob, BuildStatus, CostEntry, Deployment,
                     DeploymentStatus, DnsRecord, ObservedContainer, Project,
                     Server, ServerCapacity, Tenant, TenantUser,
                     VolumeRecord, VolumeSnapshot, WorkerPool, now_ts)
from .protocol import Connection, ProtocolServer

if TYPE_CHECKING:
    from .server import AppState

__all__ = ["register_all", "check_all_servers", "dns_sync", "execute_deploy",
           "execute_down"]

_log = get_logger("cp.deploy")

# metric catalog: docs/guide/10-observability.md. Channel label only (the
# method vocabulary is open-ended via agent commands; channels are the
# fixed 15-way enum) — bounded cardinality by construction.
_M_REQUEST_S = REGISTRY.histogram(
    "fleet_cp_request_duration_seconds",
    "Channel RPC handler latency, by channel", labels=("channel",))
_M_REQUEST_ERRORS = REGISTRY.counter(
    "fleet_cp_request_errors_total",
    "Channel RPC handlers that raised, by channel", labels=("channel",))


def check_all_servers(state: "AppState") -> dict:
    """Bulk connectivity check shared by the server.check_all channel
    method and POST /api/health-check (web.rs /api/health-check): agent
    connected == online."""
    db = state.store
    statuses = {s.slug: ("online"
                         if state.agent_registry.is_connected(s.slug)
                         else "offline")
                for s in db.list("servers")}
    return {"updated": db.bulk_server_status(statuses),
            "statuses": statuses}


def dns_sync(state: "AppState") -> dict:
    """Push unsynced records through the cloud DNS adapter; without a
    backend they stay pending (never mark unsent records synced). Shared by
    the dns.sync channel method and POST /api/dns/sync."""
    db = state.store
    pending = db.list("dns_records", lambda r: not r.synced)
    if state.dns_backend is None:
        return {"synced": 0, "pending": len(pending),
                "error": "no DNS backend configured"}
    synced = 0
    for rec in pending:
        state.dns_backend.ensure_record(
            rec.zone, rec.name, rec.type, rec.content,
            ttl=rec.ttl, proxied=rec.proxied)
        db.update("dns_records", rec.id, synced=True)
        synced += 1
    return {"synced": synced}


def _require(payload: dict, *keys: str) -> list:
    missing = [k for k in keys if k not in payload]
    if missing:
        raise ValueError(f"missing fields: {missing}")
    return [payload[k] for k in keys]


# Per-method permission verbs (per-route claims enforcement, web.rs:140 /
# auth.rs Claims analog). A connection whose
# authenticate verdict attached Claims must hold `<verb>:<channel>` (or
# admin:all / `<verb>:*`) for each call; NoAuth connections carry no claims
# and skip enforcement ("everything is the anonymous admin"). The agent
# channel is NOT wrapped here (its register-first session protocol needs
# its own state), but it is not exempt from claims: when
# a connection carries Claims it must hold write:agent (or admin:all /
# write:*) for any agent-channel method or event — otherwise a read-only
# dashboard token could register as a node, forge heartbeats, and receive
# deploy fan-out payloads containing the full flow config.
#   - secret.get is deliberately NOT read-gated: it returns decrypted
#     secret material, which a read-only dashboard grant must not reach
#   - placement.solve is NOT read-gated: solve with reserve=true creates
#     a capacity reservation (state mutation under a read grant otherwise)
_READ_METHODS = frozenset({
    "get", "list", "history", "status", "overview", "summary", "alerts",
    "logs", "logs.live", "show", "snapshots", "ps", "pool.list",
    "user.list", "ping", "reservations", "metrics", "heal.status",
    "admit_status", "obs.query", "obs.series", "obs.export",
})
def _timed(channel: str, handler):
    """Wrap a channel handler with the request-latency histogram + error
    counter (web.rs would get this from tower middleware; here it's 8
    lines around every channel, the agent session included)."""

    async def timed(conn: Connection, method: str, p: dict):
        t0 = time.perf_counter()
        try:
            return await handler(conn, method, p)
        except Exception:
            _M_REQUEST_ERRORS.inc(channel=channel)
            raise
        finally:
            _M_REQUEST_S.observe(time.perf_counter() - t0, channel=channel)

    return timed


def _perm_wrap(channel: str, handler):
    """Wrap a channel handler with claims-based permission enforcement."""

    async def wrapped(conn: Connection, method: str, p: dict):
        claims = getattr(conn, "claims", None)
        if claims is not None:
            verb = "read" if method in _READ_METHODS else "write"
            perm = f"{verb}:{channel}"
            if not claims.has(perm):
                raise PermissionError(
                    f"missing permission {perm} (have: "
                    f"{', '.join(claims.permissions) or 'none'})")
        return await handler(conn, method, p)

    return wrapped


def _role_wrap(state: "AppState", channel: str, handler):
    """Standby gating (docs/guide/13-cp-replication.md): until promotion
    a standby answers reads (dashboards pointed at it see the replicated
    state) but refuses every mutation — there is exactly one writer per
    epoch, and it is not this process."""

    async def wrapped(conn: Connection, method: str, p: dict):
        if (state.replication_role != "primary"
                and method not in _READ_METHODS):
            raise ValueError(
                f"standby: not primary — {channel}.{method} must go to "
                f"the current primary (this CP will serve writes only "
                f"after promotion)")
        return await handler(conn, method, p)

    return wrapped


def register_all(server: ProtocolServer, state: "AppState") -> None:
    """handlers/mod.rs register_all:21-35."""
    for channel, factory in (
            ("tenant", _tenant), ("project", _project), ("stage", _stage),
            ("service", _service), ("container", _container),
            ("server", _server), ("health", _health), ("cost", _cost),
            ("dns", _dns), ("deploy", _deploy), ("volume", _volume),
            ("build", _build), ("placement", _placement)):
        server.register_channel(
            channel, _timed(channel, _role_wrap(
                state, channel, _perm_wrap(channel, factory(state)))))
    agent_handler, agent_events = _agent(state)
    server.register_channel("agent", _timed("agent", agent_handler),
                            agent_events)
    repl_handler, repl_events = _replication(state)
    server.register_channel(
        "replication", _timed("replication",
                              _perm_wrap("replication", repl_handler)),
        repl_events)
    server.on_disconnect = _on_disconnect(state)


# --------------------------------------------------------------------------
# simple CRUD channels
# --------------------------------------------------------------------------

def _tenant(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "create":
            (name,) = _require(p, "name")
            t = db.create("tenants", Tenant(
                name=name, display_name=p.get("display_name", name)))
            return {"tenant": t.public_dict()}
        if method == "list":
            return {"tenants": [t.public_dict() for t in db.list("tenants")]}
        if method == "get":
            t = db.tenant_by_name(p.get("name", ""))
            return {"tenant": t.public_dict() if t else None}
        if method == "delete":
            t = db.tenant_by_name(p.get("name", ""))
            return {"deleted": bool(t and db.delete("tenants", t.id))}
        if method == "secret.set":
            name, key, value = _require(p, "name", "key", "value")
            t = db.ensure_tenant(name)
            secrets = dict(t.secrets)
            secrets[key] = (state.secret_box.encrypt(value, aad=name)
                            if state.secret_box else value)
            db.update("tenants", t.id, secrets=secrets)
            return {"ok": True}
        if method == "secret.get":
            name, key = _require(p, "name", "key")
            t = db.tenant_by_name(name)
            if t is None or key not in t.secrets:
                return {"value": None}
            v = t.secrets[key]
            return {"value": state.secret_box.decrypt(v, aad=name)
                    if state.secret_box else v}
        if method == "user.add":
            tenant, email = _require(p, "tenant", "email")
            u = db.create("tenant_users", TenantUser(
                tenant=tenant, email=email, role=p.get("role", "member")))
            return {"user": u.to_dict()}
        if method == "user.list":
            return {"users": [u.to_dict()
                              for u in db.tenant_users(p.get("tenant", ""))]}
        if method == "user.remove":
            tenant, email = _require(p, "tenant", "email")
            u = db.user_by_email(tenant, email)
            return {"removed": bool(u and db.delete("tenant_users", u.id))}
        raise ValueError(f"unknown method tenant.{method}")
    return handle


def _project(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "create":
            (name,) = _require(p, "name")
            rec = db.create("projects", Project(
                tenant=p.get("tenant", "default"), name=name,
                description=p.get("description", "")))
            return {"project": rec.to_dict()}
        if method == "list":
            tenant = p.get("tenant")
            return {"projects": [r.to_dict() for r in db.list(
                "projects", lambda r: tenant is None or r.tenant == tenant)]}
        if method == "get":
            rec = db.project_by_name(p.get("tenant", "default"),
                                     p.get("name", ""))
            return {"project": rec.to_dict() if rec else None}
        if method == "delete":
            rec = db.project_by_name(p.get("tenant", "default"),
                                     p.get("name", ""))
            return {"deleted": bool(rec and db.delete("projects", rec.id))}
        raise ValueError(f"unknown method project.{method}")
    return handle


def _stage(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "list":
            project = p.get("project", "")
            return {"stages": [s.to_dict() for s in db.stages_of(project)]}
        if method == "ensure":
            project, name = _require(p, "project", "name")
            s = db.ensure_stage(project, name,
                                backend=p.get("backend", "docker"),
                                servers=p.get("servers", []))
            return {"stage": s.to_dict()}
        if method == "status":
            # aggregate: services + last deployment + active alerts
            sid = p.get("stage", "")
            services = [s.to_dict() for s in db.services_of(sid)]
            deps = db.deployment_history(stage=sid, limit=1)
            stage = db.get("stages", sid)
            alerts = []
            if stage is not None:
                alerts = [a.to_dict() for a in db.active_alerts()
                          if any(a.server == srv for srv in stage.servers)]
            return {"services": services,
                    "last_deployment": deps[0].public_dict() if deps else None,
                    "alerts": alerts}
        if method == "adopt":
            (sid,) = _require(p, "stage")
            s = db.adopt_stage(sid)
            return {"stage": s.to_dict() if s else None}
        if method == "delete":
            return {"deleted": db.delete("stages", p.get("stage", ""))}
        raise ValueError(f"unknown method stage.{method}")
    return handle


def _service(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "list":
            return {"services": [s.to_dict()
                                 for s in db.services_of(p.get("stage", ""))]}
        if method == "restart":
            server, container = _require(p, "server", "container")
            result = await state.agent_registry.send_command(
                server, "restart", {"container": container})
            return {"result": result}
        raise ValueError(f"unknown method service.{method}")
    return handle


def _container(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "ps":
            server = p.get("server")
            rows = (db.observed_on(server) if server
                    else db.list("observed_containers"))
            return {"containers": [r.to_dict() for r in rows]}
        if method == "logs":
            server, container = _require(p, "server", "container")
            entries = state.log_router.retained(
                topic_for(server, container), limit=p.get("limit"))
            return {"lines": [e.to_dict() for e in entries]}
        if method == "logs.live":
            # live container output fetched FROM the node (the retained
            # ring above only holds agent-published lines — deploy events,
            # alerts — not container stdout)
            server, container = _require(p, "server", "container")
            result = await state.agent_registry.send_command(
                server, "logs", {"container": container,
                                 "tail": p.get("tail"),
                                 "since": p.get("since")})
            return {"logs": result.get("logs", "")}
        if method in ("start", "stop", "restart"):
            # granular lifecycle (MCP cp_container_start/stop/restart):
            # routed to the owning node's agent
            server, container = _require(p, "server", "container")
            result = await state.agent_registry.send_command(
                server, method, {"container": container})
            return {"result": result}
        raise ValueError(f"unknown method container.{method}")
    return handle


def _server(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "register":
            (slug,) = _require(p, "slug")
            rec = db.register_server(
                slug, tenant=p.get("tenant", "default"),
                hostname=p.get("hostname", slug),
                provider=p.get("provider"))
            if "capacity" in p:
                cap = type(rec.capacity)(**p["capacity"])
                db.update("servers", rec.id, capacity=cap)
            if "labels" in p:
                # wire payloads say "class" (the to_dict form); the record
                # field is clazz (keyword-safe)
                raw = dict(p["labels"])
                if "class" in raw:
                    raw["clazz"] = raw.pop("class")
                lbl = type(rec.labels)(**raw)
                db.update("servers", rec.id, labels=lbl)
            return {"server": db.get("servers", rec.id).to_dict()}
        if method == "list":
            tenant = p.get("tenant")
            return {"servers": [s.to_dict() for s in db.list(
                "servers", lambda s: tenant is None or s.tenant == tenant)]}
        if method == "get":
            s = db.server_by_slug(p.get("slug", ""))
            return {"server": s.to_dict() if s else None}
        if method == "delete":
            s = db.server_by_slug(p.get("slug", ""))
            if s is not None:
                # evict any live agent session with the record: this is the
                # operator escape hatch when a slug is held by a session
                # that should not have it (the registry's anti-hijack fence
                # otherwise keeps refusing the legitimate agent)
                live = state.agent_registry.connection_of(s.slug)
                state.agent_registry.unregister(s.slug)
                if live is not None:
                    await live.close()
                if state.failure_detector is not None:
                    # deliberate removal, not a failure: no dead verdict
                    state.failure_detector.forget(s.slug)
            return {"deleted": bool(s and db.delete("servers", s.id))}
        if method in ("cordon", "uncordon", "drain"):
            s = db.server_by_slug(p.get("slug", ""))
            if s is None:
                return {"ok": False}
            new_state = {"cordon": "cordoned", "uncordon": "schedulable",
                         "drain": "draining"}[method]
            db.update("servers", s.id, scheduling_state=new_state)
            if method == "drain":
                state.placement.node_event(s.slug, online=False)
            return {"ok": True, "scheduling_state": new_state}
        if method == "ping":
            # single-server liveness (ServerCommands::Ping): round-trip
            # through the connected agent; offline agents answer here, not
            # with a timeout
            (slug,) = _require(p, "slug")
            if not state.agent_registry.is_connected(slug):
                return {"ok": False, "error": f"agent {slug!r} not connected"}
            result = await state.agent_registry.send_command(
                slug, "ping", {}, timeout=p.get("timeout", 10))
            return {"ok": True, "result": result}
        if method in ("boot", "shutdown"):
            # ServerCommands::{Boot,Shutdown}: power control through the
            # cloud ServerProvider (server.rs power on-off); CLI shellouts
            # run off-loop like provision/deprovision
            (slug,) = _require(p, "slug")
            s = db.server_by_slug(slug)
            if s is None:
                return {"ok": False, "error": f"no server {slug}"}
            if not s.provider:
                return {"ok": False,
                        "error": f"server {slug} has no provider; "
                                 f"cannot control power"}
            sp = state.server_provider_factory(
                s.provider, **p.get("provider_args", {}))
            loop = asyncio.get_running_loop()
            infos = await loop.run_in_executor(None, sp.list_servers)
            match = next((i for i in infos if i.name == slug), None)
            if match is None:
                return {"ok": False,
                        "error": f"provider has no instance named {slug}"}
            op = sp.power_on if method == "boot" else sp.power_off
            ok = await loop.run_in_executor(None, lambda: op(match.id))
            if ok and method == "shutdown":
                db.update("servers", s.id, status="offline")
                await loop.run_in_executor(
                    None, lambda: state.placement.node_event(slug,
                                                             online=False))
            return {"ok": bool(ok), "instance": match.id}
        if method == "check_all":
            return check_all_servers(state)
        if method == "provision":
            # server.rs provision: create the machine through the cloud
            # ServerProvider, then register it (status provisioning until
            # its agent connects). CLI shellouts run off-loop.
            slug, provider_name = _require(p, "slug", "provider")
            if db.server_by_slug(slug) is not None:
                raise ValueError(f"server {slug!r} already exists")
            from ..core.model import ResourceSpec, ServerResource
            cap = p.get("capacity", {})
            spec = ServerResource(
                name=slug,
                capacity=ResourceSpec(cpu=float(cap.get("cpu", 2)),
                                      memory=float(cap.get("memory", 4096)),
                                      disk=float(cap.get("disk", 40960))),
                plan=p.get("plan"))
            sp = state.server_provider_factory(
                provider_name, **p.get("provider_args", {}))
            # the record is created BEFORE the (slow, off-loop) cloud call:
            # it reserves the slug so a concurrent provision of the same
            # slug fails the exists-check above instead of double-creating
            # a billed instance; rolled back if the provider call fails
            rec = db.create("servers", Server(
                tenant=p.get("tenant", "default"), slug=slug,
                provider=provider_name, status="provisioning",
                capacity=ServerCapacity(cpu=spec.capacity.cpu,
                                        memory=spec.capacity.memory,
                                        disk=spec.capacity.disk)))
            loop = asyncio.get_running_loop()
            try:
                info = await loop.run_in_executor(
                    None, lambda: sp.create_server(spec))
            except Exception:
                db.delete("servers", rec.id)
                raise
            db.update("servers", rec.id, hostname=info.ip or "")
            return {"server": db.get("servers", rec.id).to_dict(),
                    "instance": {"id": info.id, "status": info.status,
                                 "ip": info.ip}}
        if method == "deprovision":
            (slug,) = _require(p, "slug")
            s = db.server_by_slug(slug)
            if s is None:
                return {"ok": False, "error": f"no server {slug}"}
            loop = asyncio.get_running_loop()
            if s.provider:
                sp = state.server_provider_factory(
                    s.provider, **p.get("provider_args", {}))
                infos = await loop.run_in_executor(None, sp.list_servers)
                match = next((i for i in infos if i.name == slug), None)
                if match is not None:
                    deleted = await loop.run_in_executor(
                        None, lambda: sp.delete_server(match.id))
                    if not deleted:
                        # keep the record: the cloud instance is still
                        # running (and billing); the operator can retry
                        return {"ok": False,
                                "error": f"provider failed to delete "
                                         f"{match.id}; server record kept"}
            db.delete("servers", s.id)
            # warm re-solve of affected stages runs off-loop (the JAX solve
            # would otherwise block every heartbeat/RPC for its duration)
            await loop.run_in_executor(
                None, lambda: state.placement.node_event(slug, online=False))
            return {"ok": True}
        if method == "pool.create":
            (name,) = _require(p, "name")
            mn = int(p.get("min_servers", 0))
            mx = int(p.get("max_servers", 0))
            if mn < 0 or mx < 0:
                raise ValueError("pool min/max must be >= 0")
            if mx and mn > mx:
                raise ValueError(f"pool min_servers {mn} > max_servers {mx}")
            pool = db.create("worker_pools", WorkerPool(
                tenant=p.get("tenant", "default"), name=name,
                required_labels=p.get("required_labels", {}),
                preferred_labels=p.get("preferred_labels", {}),
                min_servers=mn, max_servers=mx))
            return {"pool": pool.to_dict()}
        if method == "pool.list":
            return {"pools": [w.to_dict() for w in db.list("worker_pools")]}
        raise ValueError(f"unknown method server.{method}")
    return handle


def _health(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "ping":
            return {"pong": True, "ts": now_ts()}
        if method == "overview":
            servers = db.list("servers")
            online = [s for s in servers if s.status == "online"]
            return {
                "servers": len(servers),
                "online": len(online),
                "agents": state.agent_registry.list_connected(),
                "projects": len(db.list("projects")),
                "deployments": len(db.list("deployments")),
                "active_alerts": len(db.active_alerts()),
                # pointer, not payload: `fleet cp status` shows the series
                # count; the full registry rides health.metrics / /metrics
                "metrics": {"families": len(REGISTRY.names())},
            }
        if method == "alerts":
            return {"alerts": [a.to_dict()
                               for a in db.active_alerts(p.get("tenant"))]}
        if method == "metrics":
            # the same registry the daemon's GET /metrics serves, in JSON
            # (the channel face for `fleet cp metrics` / MCP consumers);
            # windowed SLO gauges recompute against NOW first, same as
            # the /metrics scrape (obs/slo.py refresh)
            if state.slo is not None:
                state.slo.refresh()
            return {"metrics": REGISTRY.snapshot()}
        if method == "slo.status":
            # rolling SLO engine (obs/slo.py): declared objectives vs
            # observed quantiles + fast/slow burn rates, rendered by
            # `fleet slo status`
            if state.slo is None:
                return {"enabled": False}
            return state.slo.status()
        if method == "solver.slots":
            # device slot-manager occupancy (sched/gpu.py): which stages
            # are resident, their bytes against the budget, and what was
            # evicted with a warm snapshot — `fleet solve slots`
            return {"enabled": True, **state.placement.solver_slots()}
        if method == "heal.status":
            # self-healing introspection (`fleet cp heal status`): lease
            # table, pending/parked convergence work, pass counters —
            # plus the replication block (role/epoch/standby lag) so one
            # command answers "who is primary and is the standby warm"
            out = ({"enabled": False} if state.reconverger is None
                   else {"enabled": True, **state.reconverger.status()})
            out["replication"] = _replication_status(state)
            # per-shard occupancy/in-flight (cp/shards.py) + the
            # reconverger's aggregate debt, so the shard rows answer
            # "which partition is behind" next to the work table
            out["shards"] = {
                "count": (state.agent_registry.shard_table.shards
                          if state.agent_registry.shard_table else 1),
                "census": state.agent_registry.shard_census(),
                "debt": (state.reconverger.debt()
                         if state.reconverger else 0)}
            return out
        if method in ("obs.query", "obs.series", "obs.export"):
            # TSDB channel face (obs/tsdb.py): the windowed store behind
            # `fleet top` / `fleet obs` — standby-safe reads (the standby
            # simply has no collector, so enabled=False)
            coll = state.collector
            if coll is None:
                return {"enabled": False}
            tsdb = coll.tsdb
            if method == "obs.series":
                return {"enabled": True, "series": [
                    {"name": s.name, "labels": s.labels_dict(),
                     "kind": s.kind}
                    for s in tsdb.match(p.get("name"), p.get("labels"))],
                    "stats": tsdb.stats()}
            if method == "obs.export":
                fmt = p.get("format", "openmetrics")
                if fmt == "jsonl":
                    return {"enabled": True, "format": fmt,
                            "text": tsdb.export_jsonl()}
                if fmt == "openmetrics":
                    return {"enabled": True, "format": fmt,
                            "text": tsdb.render_openmetrics()}
                raise ValueError(f"unknown export format {fmt!r}")
            window = float(p.get("window_s", 60.0))
            return {"enabled": True, "window_s": window,
                    "collector": coll.status(),
                    "series": tsdb.aggregate(
                        name=p.get("name"), labels=p.get("labels"),
                        window_s=window)}
        raise ValueError(f"unknown method health.{method}")
    return handle


def _cost(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "add":
            month, amount = _require(p, "month", "amount")
            rec = db.create("cost_entries", CostEntry(
                tenant=p.get("tenant", "default"), server=p.get("server", ""),
                provider=p.get("provider", ""), month=month,
                amount=float(amount), currency=p.get("currency", "USD")))
            return {"entry": rec.to_dict()}
        if method == "summary":
            (month,) = _require(p, "month")
            tenant = p.get("tenant", "default")
            return {"month": month, "tenant": tenant,
                    "total": state.store.monthly_cost(tenant, month)}
        if method == "list":
            tenant = p.get("tenant")
            month = p.get("month")
            rows = db.list("cost_entries",
                           lambda e: (tenant is None or e.tenant == tenant)
                           and (month is None or e.month == month))
            return {"entries": [e.to_dict() for e in rows]}
        raise ValueError(f"unknown method cost.{method}")
    return handle


def _dns(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "create":
            zone, name, content = _require(p, "zone", "name", "content")
            rec = db.create("dns_records", DnsRecord(
                tenant=p.get("tenant", "default"), zone=zone, name=name,
                type=p.get("record_type", "A"), content=content,
                ttl=p.get("ttl", 300), proxied=p.get("proxied", False)))
            return {"record": rec.to_dict()}
        if method == "list":
            zone = p.get("zone")
            return {"records": [r.to_dict() for r in db.list(
                "dns_records", lambda r: zone is None or r.zone == zone)]}
        if method == "delete":
            # by id, or by (zone, name) the way DnsCommands::Delete
            # addresses records (main.rs:441)
            rid = p.get("id", "")
            if not rid and p.get("zone") and p.get("name"):
                rec = db.find_one(
                    "dns_records",
                    lambda r: r.zone == p["zone"] and r.name == p["name"])
                rid = rec.id if rec else ""
            return {"deleted": db.delete("dns_records", rid)}
        if method == "sync":
            return dns_sync(state)
        raise ValueError(f"unknown method dns.{method}")
    return handle


# --------------------------------------------------------------------------
# deploy channel (handlers/deploy.rs)
# --------------------------------------------------------------------------

def _deploy(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "history":
            return {"deployments": [d.public_dict() for d in db.deployment_history(
                stage=p.get("stage"), limit=p.get("limit", 50))]}
        if method == "run":
            # legacy SSH remote-exec path (handlers/deploy.rs:24-252):
            # record the deployment, ssh to the stage's server, run a
            # remote `fleet deploy`, record the outcome. Kept for servers
            # that have no agent (the reference's Tailscale-SSH deploys);
            # agent-routed `execute` is the primary path.
            slug, project_path, stage_name = _require(
                p, "server", "path", "stage")
            srv = db.server_by_slug(slug)
            if srv is None:
                raise ValueError(f"no server {slug!r}")
            tenant = db.ensure_tenant(p.get("tenant", "default"))
            project = db.ensure_project(tenant.name,
                                        p.get("project", project_path))
            stage = db.ensure_stage(project.id, stage_name)
            dep = db.create("deployments", Deployment(
                tenant=tenant.name, project=project.id, stage=stage.id,
                status=DeploymentStatus.RUNNING.value))
            from ..cloud.ssh import SshTarget, exec_with_timeout
            from ..registry.deploy import remote_deploy_cmd
            cmd = remote_deploy_cmd(project_path, stage_name,
                                    p.get("fleet_bin", "fleet"))
            target = SshTarget(host=srv.hostname or slug,
                               user=p.get("ssh_user"))
            loop = asyncio.get_running_loop()
            try:
                out = await loop.run_in_executor(
                    None, lambda: exec_with_timeout(
                        target, cmd, timeout=DEPLOY_TIMEOUT,
                        runner=getattr(state, "ssh_runner", None)))
                db.finish_deployment(dep.id, DeploymentStatus.SUCCEEDED,
                                     log=out)
            except Exception as e:
                db.finish_deployment(dep.id, DeploymentStatus.FAILED,
                                     error=str(e))
                raise
            return {"deployment": db.get("deployments", dep.id).public_dict()}
        if method == "execute":
            return await execute_deploy(
                state, DeployRequest.from_dict(p["request"]),
                tenant_name=p.get("tenant", "default"))
        if method == "down":
            return await execute_down(
                state, DeployRequest.from_dict(p["request"]),
                tenant_name=p.get("tenant", "default"),
                remove=bool(p.get("remove", False)))
        if method == "submit":
            # streaming admission (cp/admission.py, docs/guide/14): enqueue
            # arrivals/departures for the continuous micro-solve pipeline
            # instead of forcing a full deploy per change. Backpressure
            # surfaces as AdmissionRejected — retryable; the message
            # carries (reason, retry_after_s) and rides the error frame.
            adm = getattr(state, "admission", None)
            if adm is None:
                raise ValueError(
                    "streaming admission is disabled on this CP "
                    "(`admission true` in the server config)")
            stage = p.get("stage")
            loop = asyncio.get_running_loop()
            if p.get("flow") and stage:
                # first submit for a stage may carry the flow to attach
                # (runs the baseline solve off-loop)
                flow = flow_from_dict(p["flow"])
                key = f"{flow.name}/{stage}"
                await loop.run_in_executor(
                    None, lambda: adm.attach(
                        flow, stage, tenant=p.get("tenant", "default")))
                stage = key
            return await loop.run_in_executor(
                None, lambda: adm.submit(
                    p.get("tenant", "default"),
                    arrivals=p.get("arrivals") or (),
                    departures=p.get("departures") or (),
                    stage=stage))
        if method == "admit_status":
            adm = getattr(state, "admission", None)
            if adm is None:
                return {"enabled": False}
            return await asyncio.get_running_loop().run_in_executor(
                None, adm.status)
        raise ValueError(f"unknown method deploy.{method}")
    return handle


async def execute_down(state: "AppState", req: DeployRequest,
                       tenant_name: str = "default",
                       remove: bool = False) -> dict:
    """CP-routed teardown: the complement of execute_deploy (the
    reference's down is local-only, commands/down.rs — but a stage
    deployed THROUGH the CP must be torn down through it too).

    Fan deploy.down out to every connected stage agent; a stage server
    WITHOUT a live agent counts as a FAILED node (its containers are still
    running — releasing capacity for them would let the next solve
    double-book the node when it reconnects). A stage whose servers were
    never agent-routed (the CP-local deploy fallback: last deployment has
    no placement) tears down on the CP host instead. Full-stage success
    returns committed capacity, marks services removed, and the whole
    teardown lands in the deployment history like any deploy."""
    db = state.store
    tenant = db.ensure_tenant(tenant_name)
    project = db.ensure_project(tenant.name, req.flow.name)
    stage_cfg = req.flow.stage(req.stage_name)
    stage = db.ensure_stage(project.id, req.stage_name)

    # quadlet/compose tear down whole-stage only (same semantics as the
    # local CLI path, which warns and drops -n); normalizing HERE keeps
    # the capacity-release decision below consistent with what the agents
    # actually did
    from ..core.model import Backend
    if stage_cfg.backend is not Backend.DOCKER and req.target_services:
        req.target_services = []

    # "down:*" marks a FULL-stage teardown record: the placement scan
    # below stops at the last successful one (a later redeploy starts the
    # stage's placement story over)
    dep = db.create("deployments", Deployment(
        tenant=tenant.name, project=project.id, stage=stage.id,
        status=DeploymentStatus.RUNNING.value,
        services=(["down:*"] if not req.target_services
                  else [f"down:{s}" for s in req.target_services])))

    # The placement record is the truth about WHERE the stage's containers
    # live (failed deploys record none, so the scan must span the FULL
    # history — a tail of failed redeploys must not flip the verdict, and
    # deployment_history's default limit would truncate it):
    #   - some deployment recorded a placement -> agent-routed: fan out to
    #     connected agents, and every PLACED node without a live agent
    #     blocks the teardown (its containers are still running; releasing
    #     capacity for them would double-book the node on reconnect). A
    #     declared-but-never-placed offline server blocks nothing.
    #   - no placement anywhere -> the stage only ever ran through the
    #     CP-local deploy fallback: tear down on the CP host, even if
    #     agents have connected since (they hold nothing of this stage).
    placed = None
    for d in reversed(db.list("deployments",
                              lambda d: d.stage == stage.id)):
        if d.id == dep.id:
            continue
        if ((d.services or [""])[0] == "down:*"
                and d.status == DeploymentStatus.SUCCEEDED.value):
            break         # fully torn down since; older placements are moot
        if d.placement:
            placed = d.placement
            break
    nodes: dict[str, object] = {}
    errors: list[str] = []
    try:
        if placed is not None:
            # fan out to every connected node that is declared OR holds
            # placed containers — a placed node edited OUT of the config
            # still runs this stage and must be torn down (or block the
            # release while unreachable)
            placed_nodes = sorted({n for n in placed.values()})
            relevant = sorted(set(stage_cfg.servers) | set(placed_nodes))
            targets = [s for s in relevant
                       if state.agent_registry.is_connected(s)]
            missing = [s for s in placed_nodes if s not in targets]
            if targets:
                results = await state.agent_registry.send_batch(
                    [(slug, "deploy.down",
                      {"request": req.to_dict(), "remove": remove})
                     for slug in targets], timeout=DEPLOY_TIMEOUT)
                nodes = {slug: (str(r) if isinstance(r, Exception) else r)
                         for slug, r in zip(targets, results)}
                errors = [s for s, r in zip(targets, results)
                          if isinstance(r, Exception)]
            for slug in missing:
                nodes[slug] = "agent not connected (containers may still " \
                              "be running; reconnect it and re-run down)"
            errors += missing
            if not nodes:
                raise ValueError(
                    f"no connected agents among stage servers "
                    f"{stage_cfg.servers} (the stage was agent-deployed; "
                    f"reconnect the agents to tear it down)")
        else:
            engine = DeployEngine(state.backend_factory(),
                                  sleep=state.deploy_sleep)
            res = await asyncio.get_running_loop().run_in_executor(
                None, lambda: engine.down(req.flow, req.stage_name,
                                          req.target_services or None))
            nodes = {"(cp-local)": {"removed": res.removed,
                                    "backend": "docker"}}

        ok = not errors
        if ok:
            if not req.target_services:
                # full-stage teardown: capacity back, every service marked
                state.placement.release_stage(
                    f"{req.flow.name}/{req.stage_name}")
                marked = stage_cfg.services
            else:
                # targeted: no capacity release (the stage still runs),
                # but the removed services must not show 'deployed'
                marked = req.target_services
            for svc in marked:
                db.upsert_service(stage.id, svc, status="removed")
        log = "\n".join(f"{slug}: {info}" for slug, info in nodes.items())
        db.finish_deployment(
            dep.id,
            DeploymentStatus.SUCCEEDED if ok else DeploymentStatus.FAILED,
            log=log, error="; ".join(errors) if errors else "")
        return {"ok": ok, "nodes": nodes, "failed_nodes": errors,
                "deployment": db.get("deployments", dep.id).public_dict()}
    except Exception as e:
        db.finish_deployment(dep.id, DeploymentStatus.FAILED, error=str(e))
        raise


async def execute_deploy(state: "AppState", req: DeployRequest,
                         tenant_name: str = "default") -> dict:
    """The deploy.execute path (handlers/deploy.rs:280-542), shared by the
    deploy channel and the web redeploy route: record the deployment (with
    the request, so redeploy can replay it), solve placement, fan out to
    every connected stage agent (or run CP-locally), finish the record.

    The whole path runs inside ONE trace: minted here (or adopted from the
    CLI's request), carried to every agent via DeployRequest.trace_id, so
    the CP span, each agent's engine spans, and all their log lines share
    a trace_id end to end."""
    req.trace_id = req.trace_id or new_trace_id()
    with use_trace(req.trace_id):
        with span(_log, "deploy.execute", project=req.flow.name,
                  stage=req.stage_name, tenant=tenant_name) as sp:
            return await _execute_deploy(state, req, tenant_name, sp)


async def _execute_deploy(state: "AppState", req: DeployRequest,
                          tenant_name: str, sp: dict) -> dict:
    db = state.store
    tenant = db.ensure_tenant(tenant_name)
    project = db.ensure_project(tenant.name, req.flow.name)
    stage_cfg = req.flow.stage(req.stage_name)
    # fail fast on statically-doomed flows BEFORE any record is created or
    # lowering begins: the lint structural rules (dependency cycles,
    # dangling depends_on / service references) prove the deploy cannot
    # succeed on ANY inventory, so the submit is rejected with coded
    # diagnostics in milliseconds. Inventory-dependent rules are NOT run
    # here — the CP solves against live agent inventory, not the flow's
    # declared servers.
    from ..lint import deploy_blockers
    blockers = deploy_blockers(req.flow, req.stage_name)
    if blockers:
        raise ValueError(
            "flow rejected by static analysis: "
            + "; ".join(f"{d.code}: {d.message}" for d in blockers))
    stage = db.ensure_stage(project.id, req.stage_name,
                            backend=stage_cfg.backend.value,
                            servers=stage_cfg.servers)
    # the stored request is a REPLAY TEMPLATE (stage_redeploy rebuilds it
    # via from_dict): the trace id must not ride along, or every future
    # redeploy would inherit this deploy's trace and `fleet events
    # --trace` would interleave operations that ran days apart
    stored_req = req.to_dict()
    stored_req.pop("trace_id", None)
    dep = db.create("deployments", Deployment(
        tenant=tenant.name, project=project.id, stage=stage.id,
        status=DeploymentStatus.RUNNING.value,
        services=[s.name for s in stage_cfg.resolved_services(req.flow)],
        request=stored_req))

    targets = [s for s in stage_cfg.servers
               if state.agent_registry.is_connected(s)]
    try:
        if targets:
            # Fan out to EVERY connected stage server concurrently —
            # the reference routes to .first() only and defers fan-out
            # (handlers/deploy.rs:386-398); the placement solve makes
            # per-node slices explicit, so we send each agent its own.
            placement, rid = await asyncio.get_running_loop(
                ).run_in_executor(None, lambda: state.placement
                                  .solve_stage(req.flow, req.stage_name,
                                               tenant=tenant.name))
            if not placement.feasible:
                raise ValueError(
                    f"placement infeasible: {placement.violations}")
            # batched shard-parallel fan-out (cp/shards.py): the deploy
            # engine hands the registry the whole per-node command set
            # and each shard lane pipelines its slice
            results = await state.agent_registry.send_batch(
                [(slug, "deploy.execute",
                  {"request": DeployRequest(
                      flow=req.flow, stage_name=req.stage_name,
                      target_services=req.target_services,
                      no_pull=req.no_pull, no_prune=req.no_prune,
                      node=slug, trace_id=req.trace_id).to_dict(),
                   "assignment": placement.assignment})
                 for slug in targets], timeout=DEPLOY_TIMEOUT)
            errors = [str(r) for r in results if isinstance(r, Exception)]
            if errors:
                if rid:
                    state.placement.release(rid)
                raise ValueError("; ".join(errors))
            if rid:
                state.placement.commit(rid)
            log = "\n".join(str(r) for r in results
                            if not isinstance(r, Exception))
            db.update("deployments", dep.id,
                      placement=placement.assignment)
        else:
            # CP-local execution (handlers/deploy.rs:470-507)
            engine = DeployEngine(state.backend_factory(),
                                  sleep=state.deploy_sleep)
            res = await asyncio.get_running_loop().run_in_executor(
                None, lambda: engine.execute(req))
            if not res.ok:
                raise ValueError(f"failed services: {res.failed}")
            log = f"deployed {len(res.deployed)} containers locally"
        for svc in (db.get("deployments", dep.id).services or []):
            db.upsert_service(stage.id, svc, status="deployed")
        db.finish_deployment(dep.id, DeploymentStatus.SUCCEEDED, log=log)
        sp["deployment"] = dep.id
        sp["agents"] = len(targets) or None
    except Exception as e:
        db.finish_deployment(dep.id, DeploymentStatus.FAILED,
                             error=str(e))
        raise
    return {"deployment": db.get("deployments", dep.id).public_dict()}


# --------------------------------------------------------------------------
# placement channel (the card's solver surface — no reference analog)
# --------------------------------------------------------------------------

def _placement(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        if method == "solve":
            flow = flow_from_dict(p["flow"])
            # executor: a fleet-scale solve must not stall heartbeats and
            # command_result traffic on the loop (PlacementService locks
            # with threading.Lock, so it is thread-safe)
            placement, rid = await asyncio.get_running_loop().run_in_executor(
                None, lambda: state.placement.solve_stage(
                    flow, p["stage"], tenant=p.get("tenant", "default"),
                    reserve=p.get("reserve", False)))
            return {"assignment": placement.assignment,
                    "feasible": placement.feasible,
                    "violations": placement.violations,
                    "source": placement.source,
                    "solve_ms": placement.solve_ms,
                    "reservation": rid}
        if method == "node_event":
            slug, online = _require(p, "slug", "online")
            moved = await asyncio.get_running_loop().run_in_executor(
                None, lambda: state.placement.node_event(
                    slug, online=bool(online)))
            return {"rescheduled": [
                {"stage": key, "assignment": pl.assignment,
                 "feasible": pl.feasible} for key, pl in moved]}
        if method == "node_events":
            # coalesced burst: [{"slug": ..., "online": bool}, ...] -> ONE
            # warm re-solve per affected stage against the final mask
            (raw,) = _require(p, "events")
            events = [(e["slug"], bool(e["online"])) for e in raw]
            moved = await asyncio.get_running_loop().run_in_executor(
                None, lambda: state.placement.node_events(events))
            return {"rescheduled": [
                {"stage": key, "assignment": pl.assignment,
                 "feasible": pl.feasible} for key, pl in moved]}
        if method == "commit":
            return {"ok": state.placement.commit(p.get("reservation", ""))}
        if method == "release":
            return {"ok": state.placement.release(p.get("reservation", ""))}
        if method == "explain":
            # why is this service on its node (solver/explain.py): answered
            # from the retained instance, but the lock may be held by a
            # fleet-scale solve — same off-loop rule
            stage, service = _require(p, "stage", "service")
            try:
                return await asyncio.get_running_loop().run_in_executor(
                    None, lambda: state.placement.explain(
                        stage, service, top_k=int(p.get("top_k", 5))))
            except KeyError as e:
                raise ValueError(str(e)) from None
        if method == "reservations":
            # executor: the snapshot takes the PlacementService lock, which
            # a fleet-scale solve can hold for its full duration — same
            # off-loop rule as solve/node_events above
            return await asyncio.get_running_loop().run_in_executor(
                None, state.placement.reservations_snapshot)
        raise ValueError(f"unknown method placement.{method}")
    return handle


# --------------------------------------------------------------------------
# volume / build channels
# --------------------------------------------------------------------------

def _volume(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "list":
            server = p.get("server")
            return {"volumes": [v.to_dict() for v in db.list(
                "volumes", lambda v: server is None or v.server == server)]}
        if method == "adopt":
            server, name = _require(p, "server", "name")
            v = db.find_one("volumes",
                            lambda r: r.server == server and r.name == name)
            if v is None:
                v = db.create("volumes", VolumeRecord(
                    tenant=p.get("tenant", "default"), server=server,
                    name=name, adopted=True))
            else:
                db.update("volumes", v.id, adopted=True)
            return {"volume": db.get("volumes", v.id).to_dict()}
        if method == "snapshot":
            (vol_id,) = _require(p, "volume")
            snap = db.create("volume_snapshots", VolumeSnapshot(
                volume=vol_id, label=p.get("label", "")))
            return {"snapshot": snap.to_dict()}
        if method == "snapshots":
            vol = p.get("volume")
            return {"snapshots": [s.to_dict() for s in db.list(
                "volume_snapshots", lambda s: vol is None or s.volume == vol)]}
        raise ValueError(f"unknown method volume.{method}")
    return handle


def _build(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        if method == "submit":
            repo, image_tag = _require(p, "repo", "image_tag")
            job = db.create("build_jobs", BuildJob(
                tenant=p.get("tenant", "default"), repo=repo,
                ref=p.get("ref", "main"), dockerfile=p.get("dockerfile"),
                context=p.get("context", "."), image_tag=image_tag,
                push=p.get("push", False)))
            # route to a connected build worker if any
            workers = state.agent_registry.list_connected()
            if workers:
                worker = workers[0]
                db.update("build_jobs", job.id,
                          status=BuildStatus.RUNNING.value, worker=worker)
                task = asyncio.ensure_future(_run_build(state, job.id, worker))
                state.bg_tasks.add(task)   # strong ref; loop refs are weak
                task.add_done_callback(state.bg_tasks.discard)
            return {"job": db.get("build_jobs", job.id).to_dict()}
        if method == "show":
            job = db.get("build_jobs", p.get("job", ""))
            return {"job": job.to_dict() if job else None}
        if method == "list":
            return {"jobs": [j.to_dict() for j in db.list("build_jobs")]}
        if method == "logs":
            job = db.get("build_jobs", p.get("job", ""))
            return {"log": job.log if job else ""}
        if method == "cancel":
            job = db.get("build_jobs", p.get("job", ""))
            if job and job.status in (BuildStatus.QUEUED.value,
                                      BuildStatus.RUNNING.value):
                db.update("build_jobs", job.id,
                          status=BuildStatus.CANCELLED.value)
                return {"cancelled": True}
            return {"cancelled": False}
        raise ValueError(f"unknown method build.{method}")
    return handle


async def _run_build(state: "AppState", job_id: str, worker: str) -> None:
    db = state.store
    job = db.get("build_jobs", job_id)
    try:
        result = await state.agent_registry.send_command(
            worker, "build", {
                "repo": job.repo, "ref": job.ref,
                "dockerfile": job.dockerfile, "context": job.context,
                "image_tag": job.image_tag, "push": job.push},
            timeout=BUILD_TIMEOUT)
        status, extra = BuildStatus.SUCCEEDED.value, {
            "log": str(result.get("log", ""))}
    except Exception as e:
        status, extra = BuildStatus.FAILED.value, {"error": str(e)}
    # a cancel that raced the build wins: don't resurrect a cancelled job
    if db.get("build_jobs", job_id).status == BuildStatus.CANCELLED.value:
        return
    db.update("build_jobs", job_id, status=status, finished_at=now_ts(),
              **extra)


# --------------------------------------------------------------------------
# agent channel (the duplex session, handlers/agent.rs)
# --------------------------------------------------------------------------

def _ingest_heartbeat_metrics(state: "AppState", slug: str, p: dict) -> None:
    """Fold a heartbeat's piggybacked metrics snapshot into the CP's
    TSDB as agent-labeled series (the fleet-wide half of `fleet top`).
    Malformed snapshots must never fail the heartbeat itself — liveness
    detection outranks telemetry."""
    snap = p.get("metrics")
    if not snap or state.collector is None:
        return
    try:
        state.collector.ingest_agent_snapshot(slug, snap)
    except Exception:
        _log.debug("heartbeat metrics ingest failed for %s", slug,
                   exc_info=True)


def _agent(state: "AppState"):
    registered: dict[int, str] = {}   # id(conn) -> slug
    state._agent_conn_slugs = registered

    def _check_agent_perm(conn: Connection) -> None:
        """The agent channel is machine-to-machine but not
        permission-free — a token-authenticated connection must hold
        write:agent to act as a node agent."""
        claims = getattr(conn, "claims", None)
        if claims is not None and not claims.has("write:agent"):
            raise PermissionError(
                "missing permission write:agent (have: "
                f"{', '.join(claims.permissions) or 'none'})")

    def _principal_of(conn: Connection) -> str:
        claims = getattr(conn, "claims", None)
        return getattr(claims, "sub", "") or conn.identity

    async def handle(conn: Connection, method: str, p: dict) -> dict:
        db = state.store
        _check_agent_perm(conn)
        if method == "register":
            if state.replication_role != "primary":
                # re-homing: the agent's rotation lands here while this
                # standby has not promoted — refuse so it keeps cycling
                # endpoints until it finds the (possibly new) primary
                raise ValueError(
                    "standby: not primary — register with the current "
                    "primary (agents rotate cp_endpoints automatically)")
            (slug,) = _require(p, "slug")
            state.agent_registry.register(slug, conn,
                                          principal=_principal_of(conn))
            registered[id(conn)] = slug
            db.register_server(slug, hostname=p.get("hostname", slug))
            db.heartbeat(slug, version=p.get("version", ""))
            if state.failure_detector is not None:
                state.failure_detector.observe_heartbeat(slug)
            if "capacity" in p:
                s = db.server_by_slug(slug)
                db.update("servers", s.id,
                          capacity=type(s.capacity)(**p["capacity"]))
            return {"registered": True, "server": state.name}
        # register-first enforcement (handlers/agent.rs:28-63)
        if id(conn) not in registered:
            raise PermissionError("agent must register before other methods")
        slug = registered[id(conn)]
        if method == "heartbeat":
            db.heartbeat(slug, version=p.get("version", ""))
            if state.failure_detector is not None:
                state.failure_detector.observe_heartbeat(slug)
            _ingest_heartbeat_metrics(state, slug, p)
            return {"ok": True}
        raise ValueError(f"unknown method agent.{method}")

    async def events(conn: Connection, method: str, p: dict) -> None:
        db = state.store
        try:
            _check_agent_perm(conn)
        except PermissionError:
            return  # events carry no response channel: drop silently
        slug = registered.get(id(conn))
        if slug is None:
            return  # events from unregistered connections are dropped
        if method == "heartbeat":
            db.heartbeat(slug, version=p.get("version", ""))
            if state.failure_detector is not None:
                state.failure_detector.observe_heartbeat(slug)
            _ingest_heartbeat_metrics(state, slug, p)
        elif method == "alert":
            kind = p.get("kind", "unknown")
            if p.get("resolved"):
                db.resolve_alert(slug, p.get("container", ""), kind)
            else:
                db.upsert_alert(slug, p.get("container", ""), kind,
                                p.get("message", ""))
        elif method == "command_result":
            rid = p.get("request_id")
            if rid:
                state.agent_registry.resolve_result(rid, p)
        elif method == "log":
            state.log_router.publish(LogEntry(
                topic=topic_for(slug, p.get("container", "?")),
                line=p.get("line", ""), level=p.get("level", "info")))
        elif method == "inventory":
            rows = [ObservedContainer(
                server=slug, name=r.get("name", ""), image=r.get("image", ""),
                state=r.get("state", ""), health=r.get("health"),
                restart_count=r.get("restart_count", 0),
                project=r.get("project"), stage=r.get("stage"),
                service=r.get("service"), runtime=r.get("runtime", "docker"))
                for r in p.get("containers", [])]
            db.replace_observed(slug, rows)

    return handle, events


# --------------------------------------------------------------------------
# replication channel (journal shipping to standbys, cp/replication.py)
# --------------------------------------------------------------------------

def _replication_status(state: "AppState") -> dict:
    if state.replicator is not None:
        return state.replicator.status()
    if state.standby is not None:
        return state.standby.status()
    return {"role": state.replication_role,
            "epoch": state.store.epoch, "seq": state.store.seq}


def _replication(state: "AppState"):
    async def handle(conn: Connection, method: str, p: dict) -> dict:
        if method == "status":
            return _replication_status(state)
        if method == "append":
            # the push face is first of all a fencing door: a zombie
            # ex-primary that reconnects and tries to keep shipping its
            # journal is refused by epoch before anything is applied
            epoch = int(p.get("epoch", 0))
            if epoch < state.store.epoch:
                from .store import _M_FENCING
                _M_FENCING.inc(side="cp")
                raise ValueError(
                    f"fenced: entry epoch {epoch} < current epoch "
                    f"{state.store.epoch} — stale primary")
            if state.replication_role == "primary":
                raise ValueError(
                    "this CP is the primary; it does not accept "
                    "replication appends (possible split brain)")
            entries = [(int(s), ln) for s, ln in p.get("entries", [])]
            applied = state.store.apply_replicated(entries)
            return {"applied": applied, "seq": state.store.seq}
        if state.replication_role != "primary" or state.replicator is None:
            raise ValueError(
                f"standby: replication.{method} is served by the primary")
        repl = state.replicator
        if method == "ping":
            # the standby's liveness probe doubles as its ack + the
            # gossip ride-along: the reply carries the full ack table so
            # every standby can rank itself for election
            repl.ack(conn, int(p.get("acked_seq", 0)))
            st = repl.status()
            return {"pong": True, "epoch": st["epoch"], "seq": st["seq"],
                    "standbys": st["standbys"]}
        if method == "subscribe":
            return repl.attach(conn, str(p.get("identity", conn.identity)),
                               int(p.get("from_seq", 0)))
        if method == "snapshot":
            meta, chunks = repl.snapshot_chunks()
            conn._snapshot_chunks = chunks   # per-connection stash
            return meta
        if method == "snapshot_chunk":
            chunks = getattr(conn, "_snapshot_chunks", None)
            if chunks is None:
                raise ValueError("no snapshot in progress; call "
                                 "replication.snapshot first")
            i = int(p.get("chunk", 0))
            data = chunks[i]
            if i == len(chunks) - 1:
                # last chunk served: drop the stash — the connection
                # lives on for streaming and must not pin a full copy
                # of fleet state until disconnect
                conn._snapshot_chunks = None
            return {"data": data}
        raise ValueError(f"unknown method replication.{method}")

    async def events(conn: Connection, method: str, p: dict) -> None:
        if method == "ack" and state.replicator is not None:
            state.replicator.ack(conn, int(p.get("seq", 0)))

    return handle, events


def _on_disconnect(state: "AppState"):
    async def on_disconnect(conn: Connection) -> None:
        if state.replicator is not None:
            state.replicator.detach(conn)   # no-op for non-standby conns
        registered: dict[int, str] = getattr(state, "_agent_conn_slugs", {})
        slug = registered.pop(id(conn), None)
        if slug is not None:
            state.agent_registry.unregister(slug, conn)
            # fast reconnect: a newer session may already own the slug
            # (agent_registry.rs:51-53) — don't mark a live agent offline
            if not state.agent_registry.is_connected(slug):
                s = state.store.server_by_slug(slug)
                if s is not None:
                    state.store.update("servers", s.id, status="offline")
                if state.failure_detector is not None:
                    # fast-path ALIVE -> SUSPECT: the lease's renewals came
                    # over this (now dead) session. The grace window still
                    # absorbs a quick reconnect before any verdict fires.
                    state.failure_detector.observe_disconnect(slug)
    return on_disconnect
