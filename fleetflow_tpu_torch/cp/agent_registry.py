"""Agent registry: routing commands to connected node agents (the port's
copy of ``fleetflow_tpu/cp/agent_registry.py``).

Analog of controlplane agent_registry.rs: an in-memory map server_slug ->
live connection, request/response with per-call timeouts (60s default,
600s deploys, 1800s builds — agent_registry.rs:86-96), fire-and-forget
sends, and re-register-overwrites-previous semantics (:51-53).

The correlation contract matches the reference exactly (handlers/agent.rs
:97-112 + fleet-agent agent.rs:215-254): the CP wraps each command as
{"request_id": ..., "payload": ...} and the agent answers with a
`command_result` EVENT carrying the same request_id — not a protocol-level
response — which the registry correlates back to the waiting future.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import Callable, Optional, Sequence, Union

from ..core.errors import (AgentCommandError, AgentCommandFailed,
                           AgentUnreachable, ControlPlaneError)
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from .protocol import Connection
from .shards import ShardTable

log = get_logger("cp.agents")

# metric catalog: docs/guide/10-observability.md
# The gauge is process-global with last-writer-wins set() semantics: a
# production daemon has exactly one registry, and in multi-registry
# processes (tests, chaos worlds run back-to-back) it reflects whichever
# registry mutated last — which is what the chaos invariant
# (agents_gauge_consistent) relies on, since every world's bootstrap
# registers its own agents before any check runs.
_M_CONNECTED = REGISTRY.gauge(
    "fleet_agents_connected", "Node agents with a live registered session")
_M_REGISTRATIONS = REGISTRY.counter(
    "fleet_agent_registrations_total", "Agent register calls accepted")
_M_COMMANDS = REGISTRY.counter(
    "fleet_agent_commands_total", "Commands sent to agents, by command",
    labels=("command",))
_M_COMMAND_ERRORS = REGISTRY.counter(
    "fleet_agent_command_errors_total",
    "Agent commands that failed, by reason",
    labels=("reason",))

__all__ = ["AgentRegistry", "DEFAULT_TIMEOUT", "DEPLOY_TIMEOUT",
           "BUILD_TIMEOUT", "PER_SHARD_CONCURRENCY"]

DEFAULT_TIMEOUT = 60.0     # agent_registry.rs:86
DEPLOY_TIMEOUT = 600.0     # :94 (sized for image pulls)
BUILD_TIMEOUT = 1800.0     # :95

# Pipeline depth per shard lane for send_batch: up to this many commands
# of one shard's batch slice are in flight at once. Sized so a 10k-agent
# fan-out across 4 shards keeps the wire busy without unbounded task
# creation hammering one slow shard's agents.
PER_SHARD_CONCURRENCY = 32

# one batch item: (slug, command, payload)
BatchItem = tuple[str, str, Optional[dict]]


class AgentRegistry:
    def __init__(self, shard_table: Optional[ShardTable] = None):
        self._agents: dict[str, Connection] = {}
        self._principals: dict[str, str] = {}   # slug -> auth principal
        self._pending: dict[str, asyncio.Future] = {}
        # request_id -> the connection the command went to, so a
        # disconnect can fail its in-flight commands IMMEDIATELY instead
        # of letting callers sit out the full per-call timeout (a deploy
        # to a crashing agent would otherwise stall up to 600 s)
        self._pending_conn: dict[str, Connection] = {}
        # request_id -> owning shard, for the per-shard in-flight census
        self._pending_shard: dict[str, int] = {}
        self._ids = itertools.count(1)
        # Shard partitioning (cp/shards.py): every agent belongs to one
        # worker shard; send_batch pipelines each shard's batch slice
        # under that shard's concurrency bound. A registry without a
        # table (unit tests, tiny fleets) is one shard that owns all.
        self.shard_table = shard_table
        self._shard_counts: dict[int, int] = {}
        # shard id -> pipeline semaphore; rebuilt when the running loop
        # changes (tests spin a fresh loop per case)
        self._shard_sems: dict[int, asyncio.Semaphore] = {}
        self._sems_loop: Optional[asyncio.AbstractEventLoop] = None
        # stats of the most recent send_batch, pinned by the tests:
        # label_lookups < items proves the
        # per-command metric lookups stayed coalesced out of the loop
        self.last_batch_stats: dict = {}
        # delivery hook: fn(slug, command) consulted before every command
        # send. Raising ControlPlaneError surfaces to the caller exactly
        # like a dead-agent send failure — the chaos harness injects
        # partitions/latency here; it doubles as an extension point for
        # per-command routing policy (rate limits, circuit breakers).
        self.delivery_hook: Optional[Callable[[str, str], None]] = None
        # fencing (docs/guide/13-cp-replication.md): when set, every
        # command envelope is stamped with the CP's current epoch; agents
        # that have seen a newer epoch refuse the command — a zombie
        # ex-primary cannot drive stale deploys through a window it no
        # longer owns
        self.epoch_source: Optional[Callable[[], int]] = None

    # ------------------------------------------------------------------
    def register(self, slug: str, conn: Connection,
                 principal: str = "") -> None:
        """Bind slug -> live connection + auth principal.

        The reference lets any re-registration overwrite the previous
        session (agent_registry.rs:51-53) — fine when every agent is
        trusted, but it lets one compromised client hijack another node's
        command stream. Here the reconnect-wins
        semantics are kept only for the *same principal* (claims subject,
        or handshake identity when unauthenticated): a register for a slug
        whose current session is still live under a different principal is
        refused, and commands keep routing to the original session.

        The fence is only as strong as the principal: under NoAuth the
        principal is the client-chosen hello identity, and a shared token
        gives every node the same subject — mint per-node agent tokens
        (`fleet cp token --email agent@<slug> --permissions write:agent`)
        for it to bite. If a rogue session does hold a slug, the operator
        escape hatch is `server delete <slug>`, which evicts the live
        session (handlers._server delete).
        """
        existing = self._agents.get(slug)
        if (existing is not None and existing is not conn
                and not getattr(existing, "_closed", False)
                and principal != self._principals.get(slug, principal)):
            log.warning("register refused %s", kv(
                slug=slug, principal=principal,
                holder=self._principals.get(slug, "")))
            raise ControlPlaneError(
                f"agent slug {slug!r} is already registered by a live "
                f"session under a different identity")
        fresh = slug not in self._agents
        self._agents[slug] = conn
        self._principals[slug] = principal
        _M_REGISTRATIONS.inc()
        _M_CONNECTED.set(len(self._agents))
        if fresh:
            self._shard_census_delta(slug, +1)

    def unregister(self, slug: str, conn: Optional[Connection] = None) -> None:
        if conn is None or self._agents.get(slug) is conn:
            if slug in self._agents:
                self._shard_census_delta(slug, -1)
            self._agents.pop(slug, None)
            self._principals.pop(slug, None)
            _M_CONNECTED.set(len(self._agents))
        # fail the dead session's in-flight commands NOW — their results
        # can never arrive, and callers (deploys especially) must not sit
        # out the full per-call timeout against a crashed agent
        if conn is not None:
            for rid, c in list(self._pending_conn.items()):
                if c is conn:
                    fut = self._pending.get(rid)
                    if fut is not None and not fut.done():
                        fut.set_exception(AgentUnreachable(
                            f"agent {slug!r} disconnected mid-command",
                            reason="disconnected"))

    def is_connected(self, slug: str) -> bool:
        return slug in self._agents

    def list_connected(self) -> list[str]:
        return sorted(self._agents)

    def connection_of(self, slug: str) -> Optional[Connection]:
        return self._agents.get(slug)

    def inflight(self) -> int:
        """Commands awaiting a command_result — the fan-out depth the
        obs collector samples (TSDB series fleet_agent_commands_in_flight):
        the registry's fan-out bottleneck shows up here first."""
        return len(self._pending)

    # ------------------------------------------------------------------
    # shard partition bookkeeping (cp/shards.py)
    # ------------------------------------------------------------------

    def shard_of(self, slug: str) -> int:
        return self.shard_table.shard_of(slug) if self.shard_table else 0

    def _shard_census_delta(self, slug: str, delta: int) -> None:
        shard = self.shard_of(slug)
        n = self._shard_counts.get(shard, 0) + delta
        self._shard_counts[shard] = max(n, 0)
        if self.shard_table is not None:
            self.shard_table.set_shard_agents(self._shard_counts)

    def _shard_sem(self, shard: int) -> asyncio.Semaphore:
        loop = asyncio.get_running_loop()
        if loop is not self._sems_loop:
            self._shard_sems = {}
            self._sems_loop = loop
        sem = self._shard_sems.get(shard)
        if sem is None:
            sem = self._shard_sems[shard] = asyncio.Semaphore(
                PER_SHARD_CONCURRENCY)
        return sem

    def rebalance(self, shards: int) -> int:
        """Resize the shard table (FLEET_CP_SHARDS changed on a live CP)
        and re-bucket the census. No persistent state: the connected-set
        IS the journaled server/lease population, and every mapping is
        recomputed from (slug, new count). Returns moved-slug count."""
        if self.shard_table is None:
            return 0
        moved = self.shard_table.resize(shards, self._agents.keys())
        counts: dict[int, int] = {}
        for slug in self._agents:
            s = self.shard_table.shard_of(slug)
            counts[s] = counts.get(s, 0) + 1
        self._shard_counts = counts
        self.shard_table.set_shard_agents(counts)
        return moved

    def shard_census(self) -> list[dict]:
        """Per-shard occupancy + in-flight depth, sorted by shard id —
        the `fleet cp heal status` / `fleet top` shard rows."""
        shards = self.shard_table.shards if self.shard_table else 1
        pending: dict[int, int] = {}
        for sid in self._pending_shard.values():
            pending[sid] = pending.get(sid, 0) + 1
        return [{"shard": s,
                 "agents": self._shard_counts.get(s, 0),
                 "inflight": pending.get(s, 0)}
                for s in range(shards)]

    # ------------------------------------------------------------------
    async def send_command(self, slug: str, command: str,
                           payload: dict | None = None,
                           timeout: float = DEFAULT_TIMEOUT) -> dict:
        """Request/response via the command_result correlation protocol
        (agent_registry.rs send_command_with_timeout:97-134).

        Failures are STRUCTURED (core.errors): `AgentUnreachable`
        (retryable — dead/absent session, timeout, delivery refused; the
        command may never have arrived) vs `AgentCommandFailed` (fatal —
        the agent executed it and reported an error). The reconverger and
        handler callers branch on `.retryable`/type instead of
        string-matching one opaque exception. Both subclass
        ControlPlaneError, so pre-existing catch sites keep working."""
        epoch = self.epoch_source() if self.epoch_source is not None else None
        return await self._send_one(slug, command, payload, timeout,
                                    epoch=epoch, metered=True)

    async def _send_one(self, slug: str, command: str,
                        payload: Optional[dict], timeout: float, *,
                        epoch: Optional[int], metered: bool) -> dict:
        """One command send/await. `metered=False` is the batch path:
        the per-command counter and the fencing epoch were already
        resolved ONCE for the whole batch (coalesced out of the await
        loop — at 10k items the per-call label-key set comparison and
        epoch indirection are measurable in the fan-out profile)."""
        conn = self._agents.get(slug)
        if conn is None:
            _M_COMMAND_ERRORS.inc(reason="not-connected")
            raise AgentUnreachable(f"agent {slug!r} is not connected",
                                   reason="not-connected")
        if self.delivery_hook is not None:
            try:
                self.delivery_hook(slug, command)
            except AgentCommandError:
                _M_COMMAND_ERRORS.inc(reason="delivery")
                raise
            except ControlPlaneError as e:
                # hook contract: a raise means "the send failed" — which
                # is a transport failure, i.e. retryable
                _M_COMMAND_ERRORS.inc(reason="delivery")
                raise AgentUnreachable(str(e), reason="delivery") from e
        if metered:
            _M_COMMANDS.inc(command=command)
        request_id = f"req_{next(self._ids)}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        self._pending_conn[request_id] = conn
        self._pending_shard[request_id] = self.shard_of(slug)
        envelope = {"request_id": request_id, "payload": payload or {}}
        if epoch is not None:
            envelope["epoch"] = epoch
        try:
            await conn.send_event("agent", command, envelope)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            _M_COMMAND_ERRORS.inc(reason="timeout")
            raise AgentUnreachable(
                f"agent {slug!r} command {command!r} timed out "
                f"after {timeout:.0f}s", reason="timeout") from None
        except AgentCommandError as e:
            _M_COMMAND_ERRORS.inc(reason=e.reason)
            raise
        except ControlPlaneError as e:
            # a raw send_event failure (socket died under the write) is a
            # transport failure like any other: classify it retryable
            _M_COMMAND_ERRORS.inc(reason="send")
            raise AgentUnreachable(str(e), reason="send") from e
        finally:
            self._pending.pop(request_id, None)
            self._pending_conn.pop(request_id, None)
            self._pending_shard.pop(request_id, None)
            # if the disconnect path set an exception while send_event was
            # failing, retrieve it so asyncio doesn't log "exception was
            # never retrieved" at GC
            if fut.done() and not fut.cancelled():
                fut.exception()

    async def send_batch(self, items: Sequence[BatchItem], *,
                         timeout: float = DEFAULT_TIMEOUT
                         ) -> list[Union[dict, BaseException]]:
        """Shard-parallel batched delivery: the reconverger and deploy
        engine hand the registry a whole fan-out at once instead of
        gathering one-future-per-command. Each item is routed to its
        owning shard's pipeline lane and at most PER_SHARD_CONCURRENCY
        of a lane's items are in flight at a time — bounded pressure per
        shard, full parallelism across shards.

        Returns results aligned with `items` (a result dict, or the
        exception that send raised — the asyncio.gather
        return_exceptions=True shape the callers already classify).
        Per-item failures never abort the batch: a member disconnecting
        mid-batch fails only its own in-flight futures (the `_pending`
        fast-fail contract in unregister()).

        Batch-level coalescing (vs the per-call path): one per-command
        counter bump per DISTINCT command, one fencing-epoch resolution
        for the whole batch — `last_batch_stats` exposes the counts."""
        items = list(items)
        if not items:
            self.last_batch_stats = {"items": 0, "label_lookups": 0,
                                     "epoch_lookups": 0, "shards": 0}
            return []
        counts: dict[str, int] = {}
        for _, command, _ in items:
            counts[command] = counts.get(command, 0) + 1
        for command, n in counts.items():
            _M_COMMANDS.inc(n, command=command)
        epoch = self.epoch_source() if self.epoch_source is not None else None
        shards = [self.shard_of(slug) for slug, _, _ in items]
        t0 = time.perf_counter()
        done_at: dict[int, float] = {}

        async def run(shard: int, slug: str, command: str,
                      payload: Optional[dict]) -> dict:
            async with self._shard_sem(shard):
                try:
                    return await self._send_one(slug, command, payload,
                                                timeout, epoch=epoch,
                                                metered=False)
                finally:
                    done_at[shard] = time.perf_counter()

        # tasks start in item order: in production the per-shard
        # semaphores pipeline each lane independently; under the chaos
        # harness's inline sim transport nothing blocks, so execution
        # stays in creation order and schedules replay digest-stable
        tasks = [asyncio.ensure_future(run(shard, slug, command, payload))
                 for shard, (slug, command, payload) in zip(shards, items)]
        results = await asyncio.gather(*tasks, return_exceptions=True)
        if self.shard_table is not None:
            for shard, at in sorted(done_at.items()):
                self.shard_table.observe_fanout_ms(
                    shard, (at - t0) * 1000.0)
        self.last_batch_stats = {
            "items": len(items), "label_lookups": len(counts),
            "epoch_lookups": 0 if epoch is None else 1,
            "shards": len(done_at)}
        return list(results)

    async def fire_and_forget(self, slug: str, command: str,
                              payload: dict | None = None) -> None:
        conn = self._agents.get(slug)
        if conn is None:
            raise AgentUnreachable(f"agent {slug!r} is not connected",
                                   reason="not-connected")
        if self.delivery_hook is not None:
            self.delivery_hook(slug, command)
        _M_COMMANDS.inc(command=command)
        envelope = {"request_id": None, "payload": payload or {}}
        if self.epoch_source is not None:
            envelope["epoch"] = self.epoch_source()
        await conn.send_event("agent", command, envelope)

    def resolve_result(self, request_id: str, payload: dict) -> bool:
        """Called by the agent channel handler on an inbound command_result
        event (handlers/agent.rs:97-112). Returns False for unknown/expired
        ids (late results after timeout are dropped, like the reference)."""
        fut = self._pending.get(request_id)
        if fut is None or fut.done():
            return False
        if payload.get("error"):
            # the agent ran the command and said no: NOT retryable
            fut.set_exception(AgentCommandFailed(str(payload["error"])))
        else:
            fut.set_result(payload.get("result", payload))
        return True
