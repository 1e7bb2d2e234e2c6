"""The agent session: reconnect loop, registration, heartbeat, monitor,
command execution.

Analog of fleet-agent agent.rs: an infinite reconnect loop with 5s backoff
(:34-45), a session that registers first then runs heartbeat + monitor
loops concurrently with the command loop (:87-128), and the command
dispatch (deploy.execute / restart / status / build / ping, :129-208) whose
results ride the {"request_id", ...} -> command_result envelope
(:215-254).

Deploys execute the node's OWN slice of a CP-solved placement: the CP sends
`DeployRequest{node=slug}` plus the full assignment, and the engine filters
to rows assigned here (this build's multi-node fan-out; the reference routed
whole stages to one server, handlers/deploy.rs:386-394).

The port's copy of ``fleetflow_tpu/agent/agent.py``. The agent does not
place: `_placement_from` lowers the CP's flow against one synthetic local
node only for the dependency level schedule, and the card enters through
the control plane's `PlacementService`, whose solved assignment the
agent's `DeployEngine` executes. The reference's `DockerCliBackend`
default stays; the tests and chip_smoke pass a `MockBackend`.
"""

from __future__ import annotations

import asyncio
import ssl
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..runtime.backend import ContainerBackend, DockerCliBackend
from ..runtime.engine import DeployEngine, DeployRequest
from ..sched.base import Placement, level_schedule
from ..lower.tensors import lower_stage
from .guard import confine_path, validate_container_name
from .monitor import AnomalyDetector, inventory_report, snapshot_backend
from ..cp.protocol import Connection, ProtocolClient
from ..obs import get_logger, kv, span
from ..obs.metrics import REGISTRY
from ..obs.trace import use_trace

__all__ = ["Agent", "AgentConfig"]

log = get_logger("agent")

RECONNECT_BACKOFF_S = 5.0   # agent.rs:34-45

# metric catalog: docs/guide/10-observability.md. Send failures from the
# background loops used to vanish silently — a half-dead session (socket
# up, writes failing) was invisible until the CP's lease expired; now it
# shows as a rising counter on the node's own /metrics.
_M_SEND_FAILURES = REGISTRY.counter(
    "fleet_agent_send_failures_total",
    "Agent->CP event sends that failed, by originating loop",
    labels=("loop",))
_M_IDEM_REPLAYS = REGISTRY.counter(
    "fleet_agent_idempotent_replays_total",
    "Commands answered from the idempotency dedupe window instead of "
    "re-executing (CP redelivery after reconnect/timeout)")
_M_FENCED = REGISTRY.counter(
    "fleet_replication_fencing_rejections_total",
    "Stale-epoch writes refused after a failover, by side (store: "
    "replicated entries from a zombie ex-primary; cp: rejected "
    "replication RPCs; agent: fenced agent commands)", labels=("side",))


@dataclass
class AgentConfig:
    """fleet-agent main.rs:40 flags."""
    cp_host: str = "127.0.0.1"
    cp_port: int = 4510
    # replicated control plane (docs/guide/13-cp-replication.md): every
    # CP endpoint, primary first. The reconnect loop rotates through
    # them, so when the primary dies the agent re-homes to whichever
    # standby promoted — a standby refuses registration until then,
    # which reads as a failed session and advances the rotation.
    cp_endpoints: list = field(default_factory=list)  # [(host, port), ...]
    reconnect_backoff_s: Optional[float] = None   # None = module default
    slug: str = "node"
    token: Optional[str] = None
    ca_pem: Optional[bytes] = None
    heartbeat_interval_s: float = 30.0
    monitor_interval_s: float = 30.0
    restart_threshold: int = 3
    deploy_base: str = "~/.fleetflow/deploys"
    quadlet_unit_dir: Optional[str] = None   # None = user systemd dir
    capacity: dict = field(default_factory=lambda: {
        "cpu": 2.0, "memory": 4096.0, "disk": 40960.0})
    version: str = "0.1.0"
    # how long a completed command's result stays replayable by its
    # idempotency key (the CP reconverger redelivers after reconnects and
    # timeouts; a replay inside the window returns the cached result
    # instead of re-running the deploy). Sized to outlive the CP's
    # redelivery backoff ladder.
    idempotency_window_s: float = 900.0
    # fleet horizon (docs/guide/10-observability.md): piggyback a compact
    # snapshot of this node's metrics registry on every heartbeat — the
    # CP folds it into agent-labeled TSDB series for `fleet top`. At the
    # default cadence this is a few KiB per 30 s; set False to ship
    # liveness-only heartbeats.
    ship_metrics: bool = True


class Agent:
    def __init__(self, config: AgentConfig, *,
                 backend: Optional[ContainerBackend] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 systemctl=None, compose_runner=None):
        self.config = config
        self.backend = backend or DockerCliBackend()
        self.sleep = sleep
        # injectable shellouts for the non-docker deploy backends
        # (quadlet systemctl, docker compose) — tests fake these the same
        # way the CP tests fake the docker backend
        self.systemctl = systemctl
        self.compose_runner = compose_runner
        self.detector = AnomalyDetector(
            restart_threshold=config.restart_threshold)
        self.conn: Optional[Connection] = None
        self._stop = asyncio.Event()
        self._session_tasks: list[asyncio.Task] = []
        # idempotency dedupe window: key -> (monotonic done-time, result).
        # Lives on the AGENT (not the session), so a redelivery after a
        # session bounce still hits it — at-least-once CP delivery with
        # at-most-once execution inside the window. `_idem_inflight`
        # covers the gap BEFORE completion: a redelivery arriving while
        # the original is still executing (CP-side timeout + retry on a
        # slow deploy) awaits it instead of running a second copy.
        self._idem: dict[str, tuple[float, dict]] = {}
        self._idem_inflight: dict[str, asyncio.Future] = {}
        # highest controller epoch this agent has ever seen (welcome
        # frames + command envelopes). Monotonic: a command or session
        # from a LOWER epoch comes from a zombie ex-primary and is
        # refused — the fencing half of CP failover.
        self._max_epoch = 0
        self._endpoint_idx = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _endpoints(self) -> list[tuple[str, int]]:
        return (list(self.config.cp_endpoints)
                or [(self.config.cp_host, self.config.cp_port)])

    @property
    def _backoff_s(self) -> float:
        # read the module attr at call time: tests (and embedders) tune
        # RECONNECT_BACKOFF_S globally
        if self.config.reconnect_backoff_s is not None:
            return self.config.reconnect_backoff_s
        return RECONNECT_BACKOFF_S

    async def run(self) -> None:
        """Outer reconnect loop (agent.rs:30-45), rotating through every
        configured CP endpoint so a primary failover re-homes the agent
        to the promoted standby without operator help."""
        while not self._stop.is_set():
            endpoints = self._endpoints()
            host, port = endpoints[self._endpoint_idx % len(endpoints)]
            try:
                await self.run_session(host, port)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # any session failure (refused socket, auth reject -> RpcError,
                # standby's not-primary refusal, garbage frame, register
                # timeout) means "try the next endpoint after backoff",
                # never "die" (agent.rs:34-45)
                log.warning("session lost %s", kv(
                    slug=self.config.slug, cp=f"{host}:{port}", error=e,
                    retry_in_s=self._backoff_s))
            self._endpoint_idx += 1
            if self._stop.is_set():
                break
            try:
                await asyncio.wait_for(self._stop.wait(), self._backoff_s)
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._stop.set()

    async def run_session(self, host: Optional[str] = None,
                          port: Optional[int] = None) -> None:
        """One connected session (agent.rs run_session:87)."""
        host = host if host is not None else self.config.cp_host
        port = port if port is not None else self.config.cp_port
        ssl_ctx: Optional[ssl.SSLContext] = None
        if self.config.ca_pem:
            from ..cp.cert import client_ssl_context
            ssl_ctx = client_ssl_context(self.config.ca_pem)

        conn, run_task = await ProtocolClient.connect(
            host, port,
            identity=self.config.slug, token=self.config.token,
            ssl_context=ssl_ctx,
            event_handlers={"agent": self._on_command})
        self.conn = conn
        try:
            # fencing gate: a CP advertising an OLDER epoch than this
            # agent has seen is a zombie ex-primary — refuse the session
            # and let the rotation find the real primary
            welcome_epoch = conn.welcome.get("epoch")
            if welcome_epoch is not None:
                if int(welcome_epoch) < self._max_epoch:
                    _M_FENCED.inc(side="agent")
                    raise RuntimeError(
                        f"CP {host}:{port} has stale epoch "
                        f"{welcome_epoch} < {self._max_epoch}: zombie "
                        f"ex-primary, refusing to register")
                self._max_epoch = max(self._max_epoch, int(welcome_epoch))
            await conn.request("agent", "register", {
                "slug": self.config.slug,
                "hostname": self.config.slug,
                "version": self.config.version,
                "capacity": self.config.capacity,
            })
            log.info("registered %s", kv(
                slug=self.config.slug,
                cp=f"{self.config.cp_host}:{self.config.cp_port}"))
            hb = asyncio.ensure_future(self._heartbeat_loop())
            mon = asyncio.ensure_future(self._monitor_loop())
            self._session_tasks = [hb, mon]
            stop_wait = asyncio.ensure_future(self._stop.wait())
            try:
                await asyncio.wait([run_task, stop_wait],
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                for t in (hb, mon, stop_wait):
                    t.cancel()
        finally:
            self.conn = None
            await conn.close()
            run_task.cancel()

    # ------------------------------------------------------------------
    # background loops
    # ------------------------------------------------------------------

    async def _heartbeat_loop(self) -> None:
        """heartbeat.rs:10-23. A failed send ends the loop (the session
        is dying; the reconnect loop owns recovery) — but never silently:
        the failure is logged and counted, so a half-dead session is
        visible on this node's metrics BEFORE the CP's lease expires."""
        while True:
            payload: dict = {"version": self.config.version}
            if self.config.ship_metrics:
                try:
                    from ..obs.collector import compact_snapshot
                    payload["metrics"] = compact_snapshot()
                except Exception:
                    # telemetry must never cost liveness: a snapshot
                    # failure ships a plain heartbeat
                    pass
            try:
                await self.conn.send_event("agent", "heartbeat", payload)
            except Exception as e:
                _M_SEND_FAILURES.inc(loop="heartbeat")
                log.debug("heartbeat send failed %s", kv(
                    slug=self.config.slug, error=e))
                return
            await asyncio.sleep(self.config.heartbeat_interval_s)

    async def _monitor_loop(self) -> None:
        """monitor.rs run_loop:263: inventory + anomaly detection.
        Failures are survivable here (next interval retries) but must be
        visible; monitor_once counts its SEND failures separately so the
        metric stays truthful to its name."""
        while True:
            try:
                await self.monitor_once()
            except Exception as e:
                log.debug("monitor pass failed %s", kv(
                    slug=self.config.slug, error=e))
            await asyncio.sleep(self.config.monitor_interval_s)

    async def monitor_once(self) -> None:
        snaps = await asyncio.get_running_loop().run_in_executor(
            None, lambda: snapshot_backend(self.backend))
        anomalies = list(self.detector.observe(snaps))
        try:
            await self.conn.send_event(
                "agent", "inventory",
                {"containers": inventory_report(snaps)})
            for anomaly in anomalies:
                await self.conn.send_event("agent", "alert", {
                    "container": anomaly.container,
                    "kind": anomaly.kind,
                    "message": anomaly.message,
                    "resolved": anomaly.resolved,
                })
        except Exception as e:
            # only the SENDS count here: a local snapshot/detector error
            # must not look like a half-dead session to an operator
            # alerting on this family (docs/guide/10-observability.md)
            _M_SEND_FAILURES.inc(loop="monitor")
            log.debug("monitor send failed %s", kv(
                slug=self.config.slug, error=e))
            raise

    # ------------------------------------------------------------------
    # command dispatch (the envelope protocol)
    # ------------------------------------------------------------------

    async def _on_command(self, conn: Connection, method: str,
                          envelope: dict) -> None:
        """agent.rs command loop :129-208 + envelope :215-254.

        Idempotent redelivery: a payload carrying `idempotency_key` is
        executed AT MOST ONCE per window — a replay (the CP reconverger
        re-sends after reconnects and send timeouts) answers with the
        cached result instead of re-running the deploy. Only successes
        are cached; a failed command re-executes on redelivery."""
        request_id = envelope.get("request_id")
        payload = envelope.get("payload", {})
        epoch = envelope.get("epoch")
        if epoch is not None:
            if int(epoch) < self._max_epoch:
                # zombie ex-primary driving a stale command: refuse it
                # loudly — the error rides back so the sender knows it
                # has been fenced (docs/guide/13-cp-replication.md)
                _M_FENCED.inc(side="agent")
                log.warning("fenced stale command %s", kv(
                    method=method, epoch=epoch, seen=self._max_epoch,
                    slug=self.config.slug))
                if request_id:
                    try:
                        await conn.send_event("agent", "command_result", {
                            "request_id": request_id,
                            "error": f"fenced: controller epoch {epoch} < "
                                     f"{self._max_epoch}"})
                    except Exception:
                        pass
                return
            self._max_epoch = max(self._max_epoch, int(epoch))
        idem_key = (payload.get("idempotency_key")
                    if isinstance(payload, dict) else None)
        log.debug("command %s", kv(method=method, request_id=request_id,
                                   slug=self.config.slug))
        cached = self._idem_lookup(idem_key)
        if cached is None and idem_key:
            inflight = self._idem_inflight.get(idem_key)
            if inflight is not None:
                # the original is still executing: ride its outcome
                # rather than starting a concurrent duplicate; if it
                # fails, fall through and re-execute (failures are
                # never cached)
                try:
                    cached = await inflight
                except Exception:
                    cached = None
        if cached is not None:
            _M_IDEM_REPLAYS.inc()
            log.info("idempotent replay %s", kv(
                method=method, key=idem_key, slug=self.config.slug))
            reply = {"request_id": request_id, "result": cached,
                     "deduped": True}
        else:
            fut: Optional[asyncio.Future] = None
            if idem_key and idem_key not in self._idem_inflight:
                fut = asyncio.get_running_loop().create_future()
                self._idem_inflight[idem_key] = fut
            try:
                result = await self.execute_command(method, payload)
                if idem_key:
                    self._idem_store(idem_key, result)
                if fut is not None:
                    fut.set_result(result)
                reply = {"request_id": request_id, "result": result}
            except Exception as e:
                log.error("command failed %s", kv(
                    method=method, request_id=request_id, error=e))
                if fut is not None and not fut.done():
                    fut.set_exception(e)
                    fut.exception()   # mark retrieved: no-waiter GC noise
                reply = {"request_id": request_id,
                         "error": f"{type(e).__name__}: {e}"}
            finally:
                if fut is not None:
                    self._idem_inflight.pop(idem_key, None)
        if request_id:
            try:
                await conn.send_event("agent", "command_result", reply)
            except Exception as e:
                _M_SEND_FAILURES.inc(loop="command_result")
                log.debug("command_result send failed %s", kv(
                    request_id=request_id, error=e))

    def _idem_lookup(self, key: Optional[str]) -> Optional[dict]:
        if not key:
            return None
        hit = self._idem.get(key)
        if hit is None:
            return None
        done_at, result = hit
        if time.monotonic() - done_at > self.config.idempotency_window_s:
            del self._idem[key]
            return None
        return result

    def _idem_store(self, key: str, result: dict) -> None:
        now = time.monotonic()
        self._idem[key] = (now, result)
        # bounded: prune expired entries, then oldest-first past the cap
        window = self.config.idempotency_window_s
        for k in [k for k, (t, _) in self._idem.items()
                  if now - t > window]:
            del self._idem[k]
        while len(self._idem) > 256:
            oldest = min(self._idem, key=lambda k: self._idem[k][0])
            del self._idem[oldest]

    async def execute_command(self, method: str, payload: dict) -> dict:
        loop = asyncio.get_running_loop()
        if method == "ping":
            return {"pong": True, "slug": self.config.slug}

        if method == "status":
            snaps = await loop.run_in_executor(
                None, lambda: snapshot_backend(self.backend))
            return {"containers": inventory_report(snaps)}

        if method == "restart":
            name = validate_container_name(payload["container"])
            await loop.run_in_executor(None, lambda: self.backend.restart(name))
            return {"restarted": name}

        if method == "start":
            name = validate_container_name(payload["container"])
            await loop.run_in_executor(None, lambda: self.backend.start(name))
            return {"started": name}

        if method == "stop":
            name = validate_container_name(payload["container"])
            await loop.run_in_executor(None, lambda: self.backend.stop(name))
            return {"stopped": name}

        if method == "logs":
            # live container logs straight from the node's runtime (the
            # retained ring only holds agent-PUBLISHED lines like deploy
            # events; `fleet logs --cp` wants the container's own output)
            name = validate_container_name(payload["container"])
            raw_tail = payload.get("tail")
            tail = 100 if raw_tail is None else int(raw_tail)  # 0 is valid
            since = payload.get("since")
            text = await loop.run_in_executor(
                None, lambda: self.backend.logs(name, tail=tail,
                                                since=since))
            return {"logs": text}

        if method == "deploy.execute":
            req = DeployRequest.from_dict(payload["request"])
            if not req.node:
                req.node = self.config.slug
            # live streaming (agent.rs:257-333 mpsc analog): each deploy
            # event is forwarded to the CP log router AS IT HAPPENS from
            # the executor thread, so `fleet logs -f` shows the deploy in
            # flight, not a burst after completion. Send failures are
            # dropped — a slow CP must not stall the deploy.
            emit = self._live_emitter(loop, f"deploy/{req.stage_name}")

            # dispatch by the stage's execution backend
            # (agent.rs:374-445 executes Quadlet stages via apply_stage;
            # the docker path runs the placement-sliced DeployEngine)
            from ..core.model import Backend
            stage = req.flow.stage(req.stage_name)
            if stage.backend is Backend.QUADLET:
                return await loop.run_in_executor(
                    None, lambda: self._run_traced(
                        req, lambda: self._deploy_quadlet(req, emit)))
            if stage.backend is Backend.COMPOSE:
                return await loop.run_in_executor(
                    None, lambda: self._run_traced(
                        req, lambda: self._deploy_compose(req, emit)))

            placement = self._placement_from(req, payload.get("assignment"))
            engine = DeployEngine(self.backend, sleep=self.sleep)

            def run_deploy():
                # engine.execute re-enters the trace itself from
                # req.trace_id; the agent span wraps it so the flight
                # recorder shows the node-side execution as its own span
                return self._run_traced(
                    req, lambda: engine.execute(
                        req, on_event=lambda e: emit(str(e)),
                        placement=placement))

            res = await loop.run_in_executor(None, run_deploy)
            if not res.ok:
                raise RuntimeError(f"failed services: {res.failed}")
            return {"deployed": res.deployed, "removed": res.removed,
                    "duration_s": res.duration_s}

        if method == "deploy.down":
            req = DeployRequest.from_dict(payload["request"])
            emit = self._live_emitter(loop, f"deploy/{req.stage_name}")
            return await loop.run_in_executor(
                None, lambda: self._run_traced(
                    req, lambda: self._down(
                        req, bool(payload.get("remove")), emit),
                    name="agent.down"))

        if method == "build":
            return await loop.run_in_executor(
                None, lambda: self._run_build(payload))

        raise ValueError(f"unknown agent command {method!r}")

    def _run_traced(self, req: DeployRequest, fn, name: str = "agent.deploy"):
        """Run a deploy-shaped command inside the request's trace with an
        agent-side span. Commands execute on executor threads, where the
        session loop's contextvars are absent — the trace is re-entered
        from the id the CP carried in DeployRequest.trace_id, which is
        what makes one `fleet deploy` correlate across machines."""
        with use_trace(req.trace_id) as tid:
            req.trace_id = tid
            with span(log, name, slug=self.config.slug,
                      project=req.flow.name, stage=req.stage_name):
                return fn()

    def _live_emitter(self, loop: asyncio.AbstractEventLoop,
                      container: str) -> Callable[[str], None]:
        """A thread-safe log emitter: schedules the send on the session
        loop and returns immediately (the reference's mpsc sender half)."""
        conn = self.conn

        def emit(line: str) -> None:
            if conn is None:
                return
            try:
                asyncio.run_coroutine_threadsafe(
                    conn.send_event("agent", "log", {
                        "container": container, "line": line}), loop)
            except RuntimeError:
                pass   # loop already closed mid-deploy
        return emit

    def _down(self, req: DeployRequest, remove: bool, emit) -> dict:
        """Tear a stage down on this node, dispatched by the stage's
        backend like deploy.execute — the CP-routed complement of `fleet
        down` (the reference's down is local-only, commands/down.rs; a
        CP-routed deploy needs a CP-routed teardown)."""
        from ..core.model import Backend
        stage = req.flow.stage(req.stage_name)
        if stage.backend is not Backend.DOCKER and req.target_services:
            # same semantics as the local CLI path: whole-stage only (the
            # CP normalizes this before fan-out; belt-and-braces here)
            emit("targeted down is not supported on this backend; "
                 "taking the whole stage down")
            req.target_services = []
        if stage.backend is Backend.QUADLET:
            from ..runtime.quadlet import down_stage
            out = down_stage(req.flow, req.stage_name, remove=remove,
                             unit_dir=self.config.quadlet_unit_dir,
                             systemctl=self.systemctl)
            for u in out.stopped:
                emit(f"stopped {u}")
            for u in out.removed:
                emit(f"unit removed: {u}")
            for u, err in out.errors.items():
                emit(f"FAILED {u}: {err}")
            if not out.ok:
                raise RuntimeError(f"quadlet down failed: "
                                   f"{sorted(out.errors)}")
            return {"removed": out.stopped, "backend": "quadlet"}
        if stage.backend is Backend.COMPOSE:
            import os

            from ..runtime.compose import compose_down
            base = os.path.expanduser(self.config.deploy_base)
            root = str(confine_path(
                os.path.join(req.flow.name, req.stage_name), base))
            emit(f"compose down: {req.flow.name}/{req.stage_name}")
            rc, out_s = compose_down(req.flow, req.stage_name, root,
                                     runner=self.compose_runner)
            for line in out_s.strip().splitlines():
                emit(line)
            if rc != 0:
                raise RuntimeError(f"compose down failed (rc={rc}): "
                                   f"{out_s.strip()[-500:]}")
            # compose owns the per-container bookkeeping; don't claim
            # per-service precision this path doesn't have
            return {"removed": [], "backend": "compose",
                    "note": "compose down --remove-orphans"}
        engine = DeployEngine(self.backend, sleep=self.sleep)
        res = engine.down(req.flow, req.stage_name,
                          req.target_services or None,
                          on_event=lambda e: emit(str(e)))
        return {"removed": res.removed, "backend": "docker"}

    def _deploy_quadlet(self, req: DeployRequest, emit) -> dict:
        """Quadlet-backed stage through the CP (agent.rs apply_stage
        dispatch :374-445): unit generation + sync with stage-scoped
        ownership, daemon-reload, start — runtime/quadlet.py does the
        work; here we stream its outcome and keep the command contract."""
        from ..runtime.quadlet import apply_stage
        outcome = apply_stage(req.flow, req.stage_name,
                              unit_dir=self.config.quadlet_unit_dir,
                              systemctl=self.systemctl)
        for unit in outcome.written:
            emit(f"unit written: {unit}")
        for unit in outcome.removed:
            emit(f"unit removed: {unit}")
        for unit in outcome.started:
            emit(f"started {unit}")
        for unit, err in outcome.errors.items():
            emit(f"FAILED {unit}: {err}")
        if not outcome.ok:
            raise RuntimeError(f"quadlet apply failed: "
                               f"{sorted(outcome.errors)}")
        return {"deployed": outcome.started, "removed": outcome.removed,
                "backend": "quadlet"}

    def _deploy_compose(self, req: DeployRequest, emit) -> dict:
        """Compose-backed stage: emit the generated file under the agent's
        deploy workspace and run `docker compose up -d` (the reference's
        compose-path deploy with mid-deploy log streaming, agent.rs
        :257-333)."""
        import os

        from ..runtime.compose import compose_up
        # flow.name/stage_name arrive in the CP payload: confine the
        # workspace under deploy_base like _run_build confines its
        # context (a name like "../../etc" must not escape)
        base = os.path.expanduser(self.config.deploy_base)
        os.makedirs(base, exist_ok=True)
        root = str(confine_path(
            os.path.join(req.flow.name, req.stage_name), base))
        os.makedirs(root, exist_ok=True)
        emit(f"compose up: {req.flow.name}/{req.stage_name}")
        rc, out = compose_up(req.flow, req.stage_name, root,
                             runner=self.compose_runner)
        for line in out.strip().splitlines():
            emit(line)
        if rc != 0:
            raise RuntimeError(f"compose up failed (rc={rc}): "
                               f"{out.strip()[-500:]}")
        return {"deployed": [s for s in req.flow.stage(
                    req.stage_name).services],
                "removed": [], "backend": "compose"}

    def _placement_from(self, req: DeployRequest,
                        assignment: Optional[dict]) -> Optional[Placement]:
        """Rebuild a Placement from the CP's solved assignment so the engine
        executes exactly the slice assigned to this node."""
        if not assignment:
            return None
        # only the dependency level schedule matters here — the node set was
        # the CP's concern — so lower against a synthetic local node rather
        # than resolving stage.servers (which this agent can't)
        from ..lower.tensors import local_node
        pt = lower_stage(req.flow, req.stage_name,
                         nodes=[local_node(self.config.slug)])
        return Placement(assignment=dict(assignment),
                         levels=level_schedule(pt),
                         feasible=True, source="cp-solved")

    def _run_build(self, payload: dict) -> dict:
        """Build-worker path (agent.rs:476-649): git clone -> docker build
        -> optional push."""
        import os
        import tempfile
        repo, ref = payload["repo"], payload.get("ref", "main")
        tag = payload["image_tag"]
        # build workspaces live under deploy_base (agent.rs deploy_base
        # flag): big clone/build contexts land on the disk the operator
        # chose, not the root tmpfs
        base = os.path.expanduser(self.config.deploy_base)
        os.makedirs(base, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="ffbuild-", dir=base) as tmp:
            clone = subprocess.run(
                ["git", "clone", "--depth", "1", "--branch", ref, repo, tmp],
                capture_output=True, text=True)
            if clone.returncode != 0:
                raise RuntimeError(f"git clone failed: {clone.stderr.strip()}")
            # CP-supplied paths are confined to the fresh clone: a payload
            # like context="/" must not ship the host filesystem
            context = confine_path(payload.get("context", "."), tmp)
            args = ["docker", "build", "-t", tag]
            if payload.get("dockerfile"):
                args += ["-f", str(confine_path(payload["dockerfile"], tmp))]
            args.append(str(context))
            build = subprocess.run(args, cwd=tmp, capture_output=True, text=True)
            if build.returncode != 0:
                raise RuntimeError(f"docker build failed: "
                                   f"{build.stderr[-2000:]}")
            log = build.stdout[-4000:]
            if payload.get("push"):
                push = subprocess.run(["docker", "push", tag],
                                      capture_output=True, text=True)
                if push.returncode != 0:
                    raise RuntimeError(f"docker push failed: "
                                       f"{push.stderr[-2000:]}")
                log += "\n" + push.stdout[-1000:]
            return {"image": tag, "log": log}
