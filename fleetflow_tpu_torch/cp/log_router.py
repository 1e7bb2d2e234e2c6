"""Log router: pub/sub fan-out for container logs (the port's copy of
``fleetflow_tpu/cp/log_router.py``).

Analog of controlplane log_router.rs: topics named
`logs/{server}/{container}`, a retained ring buffer of 200 lines per topic
(:31), and subscribers with topic-prefix + minimum-level filters (:48-67).
Subscribers drain lane queues; slow consumers drop oldest (bounded lanes
never block the publisher — same motivation as the reference's lock-scope
discipline, agent_registry.rs:104-112).

Sharded backpressure (docs/guide/17-cp-sharding.md): each subscriber's
buffer is split into PER-SHARD LANES keyed by the publishing agent's
shard (cp/shards.py hashes the topic's server segment). A log storm from
one shard's agents — or a consumer stuck mid-drain on one shard's
output — fills and drops only that shard's lane; every other shard's
lines keep flowing to the same subscriber. Drops are counted per lane
(`fleet_cp_shard_log_dropped_total{shard=}`) on top of the aggregate,
so "which partition is being flooded" is one metric query. A router
without a shard table degrades to a single lane with the exact bounded
drop-oldest semantics the unsharded router had.
"""

from __future__ import annotations

import asyncio
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .models import now_ts
from .shards import ShardTable
from ..obs.metrics import REGISTRY

__all__ = ["LogEntry", "LogRouter", "RETAIN_LINES"]

RETAIN_LINES = 200  # log_router.rs:31

_LEVELS = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4}

# metric catalog: docs/guide/10-observability.md
_M_PUBLISHED = REGISTRY.counter(
    "fleet_log_lines_published_total", "Lines published into the log router")
_M_DELIVERED = REGISTRY.counter(
    "fleet_log_lines_delivered_total", "Line deliveries to subscriber queues")
_M_DROPPED = REGISTRY.counter(
    "fleet_log_lines_dropped_total",
    "Lines evicted from full subscriber queues (slow consumers)")


@dataclass
class LogEntry:
    """log_router.rs:19."""
    topic: str
    line: str
    level: str = "info"
    ts: float = field(default_factory=now_ts)

    def to_dict(self) -> dict:
        return {"topic": self.topic, "line": self.line,
                "level": self.level, "ts": self.ts}


def topic_for(server: str, container: str) -> str:
    return f"logs/{server}/{container}"


class _LaneQueue:
    """Per-shard lane buffers behind an asyncio.Queue-shaped facade.

    Consumers keep the queue API they always had (`await get()`,
    `get_nowait()`, `qsize()`, `empty()`); internally each publishing
    shard owns a bounded deque of `lane_size` lines, and a ready-token
    queue (one token per buffered line, in publish order) wakes the
    reader. Drop-oldest within a lane evicts a line AND leaves the token
    count intact (one out, one in), so tokens == buffered lines always.
    """

    def __init__(self, lane_size: int):
        self.lane_size = lane_size
        self._lanes: dict[int, deque[LogEntry]] = {}
        self._ready: asyncio.Queue[int] = asyncio.Queue()

    # -- publisher side (router only) ----------------------------------
    def _push(self, shard: int, entry: LogEntry) -> bool:
        """Append to the shard's lane; returns False when the lane was
        full and its oldest line was evicted to make room."""
        lane = self._lanes.get(shard)
        if lane is None:
            lane = self._lanes[shard] = deque()
        if len(lane) >= self.lane_size:
            lane.popleft()              # drop oldest, never block
            lane.append(entry)
            return False
        lane.append(entry)
        self._ready.put_nowait(shard)
        return True

    def _pop(self, shard: int) -> LogEntry:
        return self._lanes[shard].popleft()

    # -- consumer side (asyncio.Queue surface) -------------------------
    async def get(self) -> LogEntry:
        return self._pop(await self._ready.get())

    def get_nowait(self) -> LogEntry:
        return self._pop(self._ready.get_nowait())   # raises QueueEmpty

    def qsize(self) -> int:
        return self._ready.qsize()

    def empty(self) -> bool:
        return self._ready.empty()

    def full(self) -> bool:
        """Every populated lane at capacity — diagnostic only; the
        router checks individual lanes, not the whole subscriber."""
        return bool(self._lanes) and all(
            len(lane) >= self.lane_size for lane in self._lanes.values())


@dataclass
class _Subscriber:
    id: int
    prefix: str
    min_level: int
    queue: _LaneQueue
    # lines evicted from THIS subscriber's full lanes — slow-consumer
    # drops must not be silent; the aggregate
    # rides fleet_log_lines_dropped_total, the per-shard split
    # fleet_cp_shard_log_dropped_total
    dropped: int = 0
    dropped_by_shard: dict = field(default_factory=dict)


class LogRouter:
    def __init__(self, retain: int = RETAIN_LINES, queue_size: int = 1000,
                 shard_table: Optional[ShardTable] = None):
        self._retained: dict[str, deque[LogEntry]] = {}
        self._subs: dict[int, _Subscriber] = {}
        self._ids = itertools.count(1)
        self.retain = retain
        # per-LANE capacity: sharding must never shrink what a consumer
        # of a single agent's logs could buffer before drops started
        self.queue_size = queue_size
        self.shard_table = shard_table

    def _shard_of_topic(self, topic: str) -> int:
        if self.shard_table is None:
            return 0
        # topic layout logs/{server}/{container}: the SERVER owns the
        # line, so its lane is the publishing agent's registry shard
        parts = topic.split("/", 2)
        return self.shard_table.shard_of(parts[1] if len(parts) > 1 else "")

    # ------------------------------------------------------------------
    def publish(self, entry: LogEntry) -> int:
        """Retain + fan out; returns delivered count (log_router.rs:67)."""
        ring = self._retained.setdefault(entry.topic,
                                         deque(maxlen=self.retain))
        ring.append(entry)
        _M_PUBLISHED.inc()
        delivered = 0
        lvl = _LEVELS.get(entry.level, 2)
        shard = self._shard_of_topic(entry.topic)   # once per entry
        for sub in self._subs.values():
            if not entry.topic.startswith(sub.prefix):
                continue
            if lvl < sub.min_level:
                continue
            if not sub.queue._push(shard, entry):
                sub.dropped += 1
                sub.dropped_by_shard[shard] = (
                    sub.dropped_by_shard.get(shard, 0) + 1)
                _M_DROPPED.inc()
                if self.shard_table is not None:
                    self.shard_table.count_log_drop(shard)
            delivered += 1
        if delivered:
            _M_DELIVERED.inc(delivered)
        return delivered

    def publish_line(self, server: str, container: str, line: str,
                     level: str = "info") -> int:
        return self.publish(LogEntry(topic=topic_for(server, container),
                                     line=line, level=level))

    # ------------------------------------------------------------------
    def subscribe(self, prefix: str = "logs/",
                  min_level: str = "trace") -> tuple[int, _LaneQueue]:
        sid = next(self._ids)
        sub = _Subscriber(id=sid, prefix=prefix,
                          min_level=_LEVELS.get(min_level, 0),
                          queue=_LaneQueue(self.queue_size))
        self._subs[sid] = sub
        return sid, sub.queue

    def unsubscribe(self, sid: int) -> None:
        self._subs.pop(sid, None)

    def subscriber(self, sid: int) -> Optional[_Subscriber]:
        """The live subscriber record (drop count and filters) — ops
        surfaces read `.dropped` to tell a slow consumer from a quiet
        topic."""
        return self._subs.get(sid)

    def backlog(self) -> tuple[int, list[dict]]:
        """(total queued lines, per-subscriber census) — the collector's
        deep gauge: the aggregate rides `/metrics`, the per-subscriber
        rows go TSDB-only (subscriber ids are unbounded cardinality).
        qsize() is a plain length read; safe from the sampler."""
        subs = [{"subscriber": s.id, "prefix": s.prefix,
                 "queued": s.queue.qsize(), "dropped": s.dropped}
                for s in self._subs.values()]
        return sum(s["queued"] for s in subs), subs

    # ------------------------------------------------------------------
    def retained(self, topic: str, limit: Optional[int] = None) -> list[LogEntry]:
        """The cached tail served to CLI/MCP/REST without touching the agent
        (web.rs:1074; mcp lib.rs:878)."""
        ring = self._retained.get(topic, ())
        rows = list(ring)
        return rows[-limit:] if limit else rows

    def topics(self, prefix: str = "logs/") -> list[str]:
        return sorted(t for t in self._retained if t.startswith(prefix))
