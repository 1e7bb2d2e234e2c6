"""Control-plane replication: journal shipping, standby catch-up,
lease-based primary election, fencing.

The port's copy of ``fleetflow_tpu/cp/replication.py``.

The store (cp/store.py) already gives the CP a durable, replayable
journal; this module points it at OTHER PROCESSES. Borg runs an elected
Borgmaster with warm replicas holding a Paxos-replicated copy of the
cell state (Verma et al., EuroSys '15 §2.2); the same shape here rides
fleetflow's own pieces instead of a consensus library:

  journal shipping   every store mutation (including batched bursts)
                     streams to subscribed standbys as sequence-numbered
                     entries over the existing channel protocol
  gap detection      a standby applies entries at exactly seq+1; a skip
                     (slow-consumer eviction, missed frames) downgrades
                     it to snapshot catch-up — never silent divergence
  snapshot catch-up  a standby that joins late or falls behind installs
                     the primary's full snapshot (chunked under the
                     1 MiB frame cap), then resubscribes from its seq
  election           the ALIVE->SUSPECT->DEAD lease machine
                     (cp/failure_detector.py) pointed at the PRIMARY:
                     standbys ping it on an interval; a grace-expired
                     lease promotes the most-caught-up standby
  fencing            a monotonic epoch, bumped once per promotion and
                     stamped into every journal entry and agent command;
                     stale-epoch writes are refused at three doors (the
                     standby store, the replication channel, the agent)

Split-brain stance: with one standby (the supported topology) election
is trivially unique; with several, the primary gossips the ack table in
its ping replies so every standby knows who is most caught up, and only
the deterministic winner (highest acked seq, then lowest name) promotes.
Losing standbys stand down and keep re-dialing their configured primary
address — re-point them at the winner (config change, see the guide's
runbook); they do not discover its address on their own. A zombie
ex-primary that keeps running cannot damage the fleet: its epoch is
stale, so standbys refuse its journal and agents refuse its commands
(fleet_replication_fencing_rejections_total counts both).

Operator surface: `fleet cp replication status`, the replication block
in `fleet cp heal status`, and docs/guide/13-cp-replication.md (topology
+ the "my primary died" runbook).
"""

from __future__ import annotations

import asyncio
import json
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from .failure_detector import FailureDetector, LeaseConfig
from .store import ReplicationFenced, ReplicationGap, Store

log = get_logger("cp.replication")

__all__ = ["ReplicationConfig", "Replicator", "StandbyReplica",
           "StandbyRunner", "SNAPSHOT_CHUNK"]

# snapshot catch-up chunk size: comfortably under protocol.MAX_FRAME
# (1 MiB) after JSON string escaping overhead
SNAPSHOT_CHUNK = 256 * 1024

PRIMARY_SLUG = "primary"   # the one "agent" a standby's detector tracks

# metric catalog: docs/guide/13-cp-replication.md + 10-observability.md
_M_SHIPPED = REGISTRY.counter(
    "fleet_replication_entries_shipped_total",
    "Journal entries shipped to standbys (counted once per standby)")
_M_ACKED = REGISTRY.counter(
    "fleet_replication_entries_acked_total",
    "Journal entries acknowledged by standbys")
_M_LAG = REGISTRY.gauge(
    "fleet_replication_standby_lag",
    "Entries shipped but not yet acknowledged, by standby identity",
    labels=("standby",))
_M_FAILOVERS = REGISTRY.counter(
    "fleet_replication_failovers_total",
    "Standby promotions to primary (fencing epoch bumps)")
_M_CATCHUPS = REGISTRY.counter(
    "fleet_replication_snapshot_catchups_total",
    "Standby snapshot installs (bootstrap or stream-gap resync)")
_M_EPOCH = REGISTRY.gauge(
    "fleet_replication_epoch", "This CP's fencing epoch")
_M_ROLE = REGISTRY.gauge(
    "fleet_replication_role",
    "1 when this CP is the primary, 0 when a standby")


@dataclass
class ReplicationConfig:
    """Tuning knobs (docs/guide/13-cp-replication.md has sizing math).

    The election budget for a dead primary is `lease_s + grace_s` past
    the last successful ping; size `lease_s` >= 3x `ping_interval_s` so
    one dropped ping never starts the promotion clock."""
    ring_entries: int = 8192         # replayable backlog on the primary
    queue_batches: int = 4096        # per-standby send queue (batches)
    ping_interval_s: float = 2.0     # standby -> primary liveness probe
    lease_s: float = 10.0            # primary silence -> SUSPECT
    grace_s: float = 5.0             # suspect -> DEAD -> promote
    reconnect_backoff_s: float = 2.0


class _Standby:
    """Primary-side bookkeeping for one subscribed standby."""

    def __init__(self, conn, identity: str, queue_batches: int):
        self.conn = conn
        self.identity = identity
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=queue_batches)
        self.acked_seq = 0
        self.sent_seq = 0
        self.task: Optional[asyncio.Task] = None


class Replicator:
    """Primary-side journal shipper.

    Owns the store's `replication_sink`: every emitted entry lands in a
    bounded ring (the replayable backlog) and on each subscribed
    standby's send queue. The sink runs under the store lock — possibly
    on an executor thread — so it only buffers; the asyncio loop drains
    each standby's queue in order. A standby whose queue overflows has
    its queue cleared and keeps streaming: the seq gap it then observes
    downgrades it to snapshot catch-up (gap detection does the work a
    bespoke slow-consumer protocol would)."""

    def __init__(self, store: Store, *,
                 config: Optional[ReplicationConfig] = None,
                 loop: Optional[asyncio.AbstractEventLoop] = None):
        self.store = store
        self.config = config or ReplicationConfig()
        self._loop = loop
        self._ring: deque[tuple[int, str]] = deque(
            maxlen=self.config.ring_entries)
        # the sink runs under the STORE lock, possibly on an executor
        # thread, while attach/snapshot run on the asyncio loop — the
        # ring needs its own lock
        self._ring_lock = threading.Lock()
        self._standbys: dict[int, _Standby] = {}   # id(conn) -> state
        store.replication_sink = self._sink
        _M_EPOCH.set(store.epoch)
        _M_ROLE.set(1)

    # -- the store-lock side -------------------------------------------

    def _sink(self, entries: list[tuple[int, str]]) -> None:
        with self._ring_lock:
            self._ring.extend(entries)
        if not self._standbys:
            return
        loop = self._loop
        if loop is None:
            return
        loop.call_soon_threadsafe(self._fan_out, list(entries))

    # -- the asyncio side ----------------------------------------------

    def _fan_out(self, entries: list[tuple[int, str]]) -> None:
        for sb in list(self._standbys.values()):
            try:
                sb.queue.put_nowait(entries)
            except asyncio.QueueFull:
                # slow consumer: drop its backlog; the seq gap it sees
                # next forces a snapshot resync (never silent divergence)
                log.warning("standby send queue overflow %s",
                            kv(standby=sb.identity))
                while not sb.queue.empty():
                    sb.queue.get_nowait()

    async def _sender(self, sb: _Standby) -> None:
        try:
            while True:
                entries = await sb.queue.get()
                await sb.conn.send_event("replication", "append", {
                    "epoch": self.store.epoch,
                    "entries": entries,
                })
                sb.sent_seq = max(sb.sent_seq, entries[-1][0])
                _M_SHIPPED.inc(len(entries))
                _M_LAG.set(max(sb.sent_seq - sb.acked_seq, 0),
                           standby=sb.identity)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("standby stream ended %s",
                        kv(standby=sb.identity, error=e))
            self.detach(sb.conn)

    def attach(self, conn, identity: str, from_seq: int) -> dict:
        """`replication.subscribe`: register the connection as a standby
        sink. If `from_seq` is inside the ring window the backlog is
        queued and streaming begins; otherwise the standby must install
        a snapshot first (`snapshot_needed`)."""
        # lock order: the sink runs store-lock -> ring-lock, so NOTHING
        # here may touch the store while holding the ring lock (ABBA)
        store_seq, store_epoch = self.store.seq, self.store.epoch
        with self._ring_lock:
            ring_first = (self._ring[0][0] if self._ring
                          else store_seq + 1)
            if from_seq + 1 < ring_first:
                return {"snapshot_needed": True, "seq": store_seq,
                        "epoch": store_epoch}
            backlog = [(s, ln) for s, ln in self._ring if s > from_seq]
        sb = _Standby(conn, identity, self.config.queue_batches)
        sb.acked_seq = from_seq
        sb.sent_seq = from_seq
        if backlog:
            sb.queue.put_nowait(backlog)
        self._standbys[id(conn)] = sb
        sb.task = asyncio.ensure_future(self._sender(sb))
        log.info("standby subscribed %s", kv(
            standby=identity, from_seq=from_seq, backlog=len(backlog)))
        return {"subscribed": True, "seq": store_seq, "epoch": store_epoch}

    def detach(self, conn) -> None:
        sb = self._standbys.pop(id(conn), None)
        if sb is not None and sb.task is not None:
            sb.task.cancel()

    def ack(self, conn, seq: int) -> None:
        sb = self._standbys.get(id(conn))
        if sb is None:
            return
        newly = max(seq - sb.acked_seq, 0)
        sb.acked_seq = max(sb.acked_seq, seq)
        if newly:
            _M_ACKED.inc(newly)
        _M_LAG.set(max(sb.sent_seq - sb.acked_seq, 0), standby=sb.identity)

    # -- snapshot catch-up ---------------------------------------------

    def snapshot_chunks(self) -> tuple[dict, list[str]]:
        """Serialize the current snapshot into frame-safe chunks. Returns
        (meta, chunks); the standby fetches chunks by index and installs
        the reassembled document."""
        blob = json.dumps(self.store.snapshot_doc())
        chunks = [blob[i:i + SNAPSHOT_CHUNK]
                  for i in range(0, len(blob), SNAPSHOT_CHUNK)] or [""]
        meta = {"chunks": len(chunks), "bytes": len(blob),
                "seq": self.store.seq, "epoch": self.store.epoch}
        return meta, chunks

    # -- introspection --------------------------------------------------

    def status(self) -> dict:
        return {
            "role": "primary",
            "epoch": self.store.epoch,
            "seq": self.store.seq,
            "ring": {"entries": len(self._ring),
                     "first_seq": (self._ring[0][0]
                                   if self._ring else None)},  # benign race
            "standbys": [
                {"identity": sb.identity, "acked_seq": sb.acked_seq,
                 "sent_seq": sb.sent_seq,
                 "lag": max(sb.sent_seq - sb.acked_seq, 0)}
                for sb in sorted(self._standbys.values(),
                                 key=lambda s: s.identity)],
        }

    def max_lag(self) -> int:
        return max((sb.sent_seq - sb.acked_seq
                    for sb in self._standbys.values()), default=0)


class StandbyReplica:
    """Standby-side apply surface around a Store: stream entries in,
    detect gaps, install snapshots, promote. Transport-free so the chaos
    harness can drive it in-process and deterministically."""

    def __init__(self, store: Store):
        self.store = store
        self.applied = 0
        self.catchups = 0

    @property
    def last_seq(self) -> int:
        return self.store.seq

    def apply_lines(self, entries: list[tuple[int, str]]) -> int:
        """Apply shipped entries; raises ReplicationGap (resync needed)
        or ReplicationFenced (zombie writer) — both from the store."""
        n = self.store.apply_replicated(entries)
        self.applied += n
        return n

    def install(self, doc: dict) -> None:
        self.store.install_snapshot(doc)
        self.catchups += 1
        _M_CATCHUPS.inc()

    def promote(self) -> int:
        """Become the primary: bump the fencing epoch (journaled, so it
        replicates to any standby of OUR own) and flip the role gauges.
        The caller wires up the primary-side machinery (detector,
        reconverger, Replicator) around the promoted store."""
        epoch = self.store.bump_epoch()
        _M_FAILOVERS.inc()
        _M_EPOCH.set(epoch)
        _M_ROLE.set(1)
        log.warning("promoted to primary %s", kv(epoch=epoch,
                                                 seq=self.store.seq))
        return epoch


class StandbyRunner:
    """The standby's life: dial the primary, catch up, stream, watch the
    primary's lease, promote when it dies.

    The liveness signal is the standby's OWN FailureDetector tracking a
    single synthetic agent (the primary): every successful ping — and
    every applied append batch — renews the lease; a dropped connection
    fast-paths to SUSPECT exactly like an agent session loss. When the
    grace expires, the most-caught-up standby (by the ack table the
    primary gossips in ping replies) promotes; the rest stand down and
    keep re-dialing their CONFIGURED primary address — the operator
    re-points them at the winner (guide 13 runbook)."""

    def __init__(self, replica: StandbyReplica, host: str, port: int, *,
                 identity: str = "standby",
                 token: Optional[str] = None,
                 config: Optional[ReplicationConfig] = None,
                 on_promote: Optional[Callable[[], None]] = None,
                 clock=None):
        self.replica = replica
        self.host = host
        self.port = port
        self.identity = identity
        self.token = token
        self.config = config or ReplicationConfig()
        self.on_promote = on_promote
        self.detector = FailureDetector(
            LeaseConfig(lease_s=self.config.lease_s,
                        suspect_grace_s=self.config.grace_s),
            **({"clock": clock} if clock else {}))
        self.promoted = False
        self.conn = None
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()
        self._ack_table: dict[str, int] = {}
        _M_ROLE.set(0)

    # -- wiring ---------------------------------------------------------

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self.run())
        return self._task

    def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def run(self) -> None:
        while not self._stop.is_set() and not self.promoted:
            try:
                await self._session()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("standby session lost %s", kv(
                    primary=f"{self.host}:{self.port}", error=e))
            if self.promoted or self._stop.is_set():
                break
            # the dead session fast-paths the lease to SUSPECT; keep
            # sweeping while disconnected so grace expiry still promotes
            self.detector.observe_disconnect(PRIMARY_SLUG)
            deadline = (self.config.lease_s + self.config.grace_s
                        ) / max(self.config.ping_interval_s, 1e-9)
            for _ in range(int(deadline) + 2):
                if self._sweep_and_maybe_promote():
                    return
                try:
                    await asyncio.wait_for(
                        self._stop.wait(), self.config.ping_interval_s)
                    return
                except asyncio.TimeoutError:
                    pass
            await asyncio.sleep(self.config.reconnect_backoff_s)

    # -- one connected session -----------------------------------------

    async def _session(self) -> None:
        from .protocol import ProtocolClient
        conn, run_task = await ProtocolClient.connect(
            self.host, self.port, identity=self.identity, token=self.token,
            event_handlers={"replication": self._on_event})
        self.conn = conn
        try:
            self.detector.observe_heartbeat(PRIMARY_SLUG)
            sub = await conn.request("replication", "subscribe",
                                     {"from_seq": self.replica.last_seq,
                                      "identity": self.identity})
            if sub.get("snapshot_needed"):
                await self._catch_up(conn)
                sub = await conn.request(
                    "replication", "subscribe",
                    {"from_seq": self.replica.last_seq,
                     "identity": self.identity})
            if not sub.get("subscribed"):
                raise RuntimeError(f"subscribe refused: {sub}")
            log.info("streaming from primary %s", kv(
                primary=f"{self.host}:{self.port}",
                seq=self.replica.last_seq, epoch=sub.get("epoch")))
            while not self._stop.is_set():
                try:
                    pong = await conn.request(
                        "replication", "ping",
                        {"identity": self.identity,
                         "acked_seq": self.replica.last_seq},
                        timeout=self.config.ping_interval_s * 4)
                    self.detector.observe_heartbeat(PRIMARY_SLUG)
                    self._ack_table = {
                        s["identity"]: s["acked_seq"]
                        for s in pong.get("standbys", [])}
                except Exception:
                    # a failed ping is a missed heartbeat, nothing more:
                    # the lease machine decides when silence means death
                    pass
                if self._sweep_and_maybe_promote():
                    return
                if run_task.done():
                    raise RuntimeError("primary connection closed")
                try:
                    await asyncio.wait_for(self._stop.wait(),
                                           self.config.ping_interval_s)
                    return
                except asyncio.TimeoutError:
                    pass
        finally:
            self.conn = None
            await conn.close()
            run_task.cancel()

    async def _on_event(self, conn, method: str, payload: dict) -> None:
        if method != "append":
            return
        entries = [(int(s), ln) for s, ln in payload.get("entries", [])]
        try:
            self.replica.apply_lines(entries)
        except ReplicationGap:
            log.warning("stream gap; resyncing from snapshot %s",
                        kv(at_seq=self.replica.last_seq))
            await self._catch_up(conn)
        except ReplicationFenced as e:
            log.error("fenced append from stale primary %s", kv(error=e))
            return
        self.detector.observe_heartbeat(PRIMARY_SLUG)
        try:
            await conn.send_event("replication", "ack",
                                  {"seq": self.replica.last_seq})
        except Exception:
            pass   # the stream will resync on the next session

    async def _catch_up(self, conn) -> None:
        meta = await conn.request("replication", "snapshot", {})
        parts = []
        for i in range(int(meta["chunks"])):
            part = await conn.request("replication", "snapshot_chunk",
                                      {"chunk": i})
            parts.append(part["data"])
        self.replica.install(json.loads("".join(parts) or "{}"))
        log.info("snapshot installed %s", kv(
            seq=self.replica.last_seq, bytes=meta.get("bytes")))

    # -- election -------------------------------------------------------

    def _most_caught_up(self) -> bool:
        """Deterministic winner among the standbys the primary last
        gossiped: highest acked seq wins, ties break on lowest identity.
        An empty table (single-standby topology, or the primary died
        before ever gossiping) means we are the only candidate."""
        mine = self.replica.last_seq
        for ident, acked in sorted(self._ack_table.items()):
            if ident == self.identity:
                continue
            if acked > mine or (acked == mine and ident < self.identity):
                return False
        return True

    def _sweep_and_maybe_promote(self) -> bool:
        verdicts = self.detector.sweep()
        if not any(not v.online for v in verdicts):
            return False
        if not self._most_caught_up():
            log.info("primary dead but a peer standby is more caught up "
                     "%s", kv(mine=self.replica.last_seq,
                              table=dict(sorted(self._ack_table.items()))))
            return False
        self.promoted = True
        self.replica.promote()
        if self.on_promote is not None:
            self.on_promote()
        return True

    # -- introspection ---------------------------------------------------

    def status(self) -> dict:
        return {
            "role": "primary" if self.promoted else "standby",
            "primary": f"{self.host}:{self.port}",
            "epoch": self.replica.store.epoch,
            "seq": self.replica.last_seq,
            "applied": self.replica.applied,
            "snapshot_catchups": self.replica.catchups,
            "primary_lease": self.detector.status()["agents"].get(
                PRIMARY_SLUG),
        }
